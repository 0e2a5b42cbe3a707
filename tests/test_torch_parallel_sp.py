"""Ring attention (``uurg_torch/parallel/sequence.py``) on gloo ranks (CPU)
against the JAX package's ``ring_attention`` on the virtual CPU devices
and against the plain attention: the forward at ``seq`` 2 and 4, the
gradients of q, k and v, ``data=2,seq=2``, bf16 inputs, the refusal of an
indivisible token count; the one-process loopback at 2, 4 and 8 ranks;
the ``sequence_parallel`` context routing every DiT block's attention
through the ring and SD's self-attention but not what stays local;
``dit_forget`` and ``nsfw_removal`` under ``sp`` on two ranks against one
process.

JAX's shapes: (B, H, T, D) = (2, 3, 16, 8), (4, 3, 16, 8) under
``data=2``. float32 at JAX's own bounds (1e-5; gradients rtol 1e-4),
bf16 at its 3e-2."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from tests.torch_parallel_ranks import one_rank_group  # noqa: E402
from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_torch.parallel import sequence as SQ  # noqa: E402
from uurg_tpu.ops.flash_attention import _reference_attention  # noqa: E402
from uurg_tpu.parallel import make_mesh as j_mesh  # noqa: E402
from uurg_tpu.parallel import ring_attention as j_ring  # noqa: E402

TOL, GRAD_RTOL, BF16_TOL = 1e-5, 1e-4, 3e-2
# the runners under sp against one process: tests/test_parallel.py's bounds
# for a sharded DiT step; SD's one SGD step (tests/test_torch_parallel_sd)
RTOL, ATOL, LOSS_REL, SD_PARAM_ABS = 2e-4, 2e-5, 1e-5, 2e-6
SPECS_2, SPECS_4 = ["seq=2"], ["seq=4", "data=2,seq=2"]
SD_B, SD_LATENT, SD_CTX = 2, 16, (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(key, B=2, H=3, T=16, D=8, dtype=jnp.float32):
    ks = jax.random.split(key, 4)
    return tuple(jax.random.normal(k, (B, H, T, D), dtype) for k in ks)


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)


def _inputs(spec: str, dtype) -> dict:
    B = 4 if spec.startswith("data") else 2
    q, k, v, tgt = _qkv(jax.random.key(sum(map(ord, spec))), B=B,
                        dtype=dtype)
    return {"q": q, "k": k, "v": v, "target": tgt.astype(jnp.float32)}


def _sd_batch(rng, n_ctx):
    return (torch.from_numpy(rng.standard_normal(
        (SD_B, SD_LATENT, SD_LATENT, 4)).astype(np.float32)),
        *(torch.from_numpy(rng.standard_normal((SD_B, *SD_CTX))
                           .astype(np.float32)) for _ in range(n_ctx)))


def _dit_batch(rng, n=8):
    return (torch.from_numpy(rng.standard_normal((n, 8, 8, 4))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, n)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    arrays = {dt: {s: _inputs(s, dt) for s in SPECS_2 + SPECS_4}
              for dt in (jnp.float32, jnp.bfloat16)}
    rng = np.random.default_rng(0)
    dit = PR.dit_workload().init_params(0)
    unet = PR.sd_workload().init_unet(0)
    ranks_dir = tmp / "ranks"
    ranks_dir.mkdir()
    data = {
        "f32": {s: {n: _torch(a) for n, a in d.items()}
                for s, d in arrays[jnp.float32].items()},
        "bf16": {s: {n: _torch(a) for n, a in d.items()}
                 for s, d in arrays[jnp.bfloat16].items()},
        "dit": {"state": {k: v.detach().clone()
                          for k, v in dit.state_dict().items()},
                "mask": {n: torch.from_numpy(rng.random(tuple(p.shape))
                                             < 0.6)
                         for n, p in dit.named_parameters()},
                "batches_f": [_dit_batch(rng) for _ in range(2)],
                "batches_r": [_dit_batch(rng) for _ in range(2)]},
        "sd": {"tmp": str(ranks_dir),
               "state": {k: v.detach().clone()
                         for k, v in unet.state_dict().items()},
               "mask": {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
                        for n, p in unet.named_parameters()},
               "forget": [_sd_batch(rng, 2)], "remain": [_sd_batch(rng, 1)]}}
    torch.save(data, tmp / "in.pt")
    PR.spawn("ring", 2, tmp, str(tmp / "in.pt"), SPECS_2, True)
    two = [torch.load(tmp / f"ring_rank{r}.pt", weights_only=False)
           for r in range(2)]
    PR.spawn("ring", 4, tmp, str(tmp / "in.pt"), SPECS_4, False)
    four = [torch.load(tmp / f"ring_rank{r}.pt", weights_only=False)
            for r in range(4)]
    return types.SimpleNamespace(tmp=tmp, arrays=arrays, data=data, two=two,
                                 four=four)


def _jax_ring(a, spec, grads=True):
    """JAX's ring on the virtual devices of ``spec``'s mesh: the output
    and the gradients of mean((o - target)^2)."""
    axes = {n: int(s) for n, s in (p.split("=") for p in spec.split(","))}
    size = int(np.prod(list(axes.values())))
    mesh = j_mesh(axes, devices=jax.devices()[:size])

    def ring(q, k, v):
        return j_ring(q, k, v, mesh=mesh)

    out = jax.jit(ring)(a["q"], a["k"], a["v"])
    if not grads:
        return out, None

    def loss(q, k, v):
        return jnp.mean((ring(q, k, v).astype(jnp.float32)
                         - a["target"]) ** 2)

    return out, jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        a["q"], a["k"], a["v"])


@pytest.mark.parametrize("spec", SPECS_2 + SPECS_4)
def test_ring_attention_matches_jax_and_reference(setup, spec):
    a = setup.arrays[jnp.float32][spec]
    out, grads = _jax_ring(a, spec)
    ref = _reference_attention(a["q"], a["k"], a["v"])
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    ranks = setup.two if spec in SPECS_2 else setup.four
    for r, got in enumerate(ranks):
        g = got[spec]["f32"]
        np.testing.assert_allclose(g["out"].numpy(), np.asarray(out),
                                   atol=TOL, rtol=TOL, err_msg=f"rank {r}")
        for name, mine, want in zip("qkv", g["grads"], grads):
            np.testing.assert_allclose(mine.numpy(), np.asarray(want),
                                       atol=TOL, rtol=GRAD_RTOL,
                                       err_msg=f"d{name} rank {r}")


@pytest.mark.parametrize("spec", SPECS_2 + SPECS_4)
def test_ring_attention_bf16_inputs(setup, spec):
    a = setup.arrays[jnp.bfloat16][spec]
    out, _ = _jax_ring(a, spec, grads=False)
    ref = _reference_attention(a["q"], a["k"], a["v"])
    ranks = setup.two if spec in SPECS_2 else setup.four
    for got in ranks:
        g = got[spec]["bf16"]["out"]
        assert g.dtype == torch.bfloat16
        for want in (out, ref):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=BF16_TOL, rtol=BF16_TOL)


def test_ring_attention_rejects_indivisible_tokens():
    q, k, v, _ = (_torch(a) for a in _qkv(jax.random.key(5), T=12))
    mesh = types.SimpleNamespace(mesh_dim_names=("seq",), shape=(8,))
    with pytest.raises(ValueError, match="divisible"):
        SQ.ring_attention(q, k, v, mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        SQ.ring_attention_loopback(q, k, v, 8)


@pytest.mark.parametrize("seq", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_loopback_matches_jax_and_plain(seq, dtype):
    """All ranks in one process, with no spawn: the forward against JAX's
    ring at the same seq and the plain attention, the gradients against
    autograd of the plain attention; one rank gives the one-device call's
    bits."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    arrs = _qkv(jax.random.key(seq), dtype=jdt)
    q, k, v, g = (_torch(a) for a in arrs)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = SQ.ring_attention_loopback(*leaves, seq)
    grads = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = FA.attention_plain(*plain)
    ref_grads = torch.autograd.grad(ref, plain, g)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    jout, _ = _jax_ring({"q": arrs[0], "k": arrs[1], "v": arrs[2]},
                        f"seq={seq}", grads=False)
    for want in (ref.detach().float().numpy(), np.asarray(jout, np.float32)):
        np.testing.assert_allclose(out.detach().float().numpy(), want,
                                   atol=tol, rtol=tol)
    for name, mine, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(mine.float().numpy(),
                                   want.float().numpy(), atol=tol,
                                   rtol=GRAD_RTOL if tol == TOL else tol,
                                   err_msg=f"d{name}")
    if seq == 1:
        assert torch.equal(out, FA.attention(*leaves))


def test_chunk_plain_versions_are_the_attention_in_one_chunk():
    """The chunk forward's plain version with its natural-log lse, and the
    chunk backward's with the chunk's own o and lse, are the plain
    attention and its backward."""
    q, k, v, g = (_torch(a) for a in _qkv(jax.random.key(6)))
    o, lse = SQ.chunk_attention_plain(q, k, v)
    assert lse.shape == (6, 16) and lse.dtype == torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 8 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(6, 16))
    torch.testing.assert_close(o, FA.attention_plain(q, k, v))
    for mine, want in zip(SQ.chunk_attention_bwd_plain(q, k, v, o, lse, g),
                          FA.attention_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(mine, want, atol=TOL, rtol=TOL)


def test_dispatcher_routes_by_token_count(monkeypatch):
    """Under the context, a call whose tokens divide by the seq axis goes
    to the ring; one whose tokens do not stays local, as JAX routes SD's
    cross-attention over 77 text tokens."""
    calls = []
    monkeypatch.setattr(SQ, "ring_attention",
                        lambda q, k, v, **kw: calls.append(kw) or q)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "seq"),
                                 shape=(1, 4))
    q16 = torch.randn(1, 2, 16, 8)
    q15 = torch.randn(1, 2, 15, 8)
    with SQ.sequence_parallel(mesh):
        assert FA.attention(q16, q16, q16) is q16
        out = FA.attention(q15, q15, q15)
    assert [c["axis"] for c in calls] == ["seq"]
    assert calls[0]["mesh"] is mesh and calls[0]["batch_axis"] == "data"
    torch.testing.assert_close(out, FA.attention_plain(q15, q15, q15))
    assert SQ.active_sequence_parallel() is None


def test_context_routes_every_dit_block(monkeypatch):
    """Every block's attention of a DiT forward and backward inside the
    context takes the ring (depth calls forward, depth more in the remat
    recompute), on a one-rank seq axis with one device's bits."""
    from uurg_torch.models.dit import DiTConfig, init_dit

    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4, hidden_size=32,
                    depth=2, num_heads=4, num_classes=10, dtype=torch.float32)
    model = init_dit(0, cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x, t, y = torch.randn(2, 8, 8, 4), torch.zeros(2), torch.zeros(2).long()
    want = model(x, t, y)
    want.square().mean().backward()
    want_grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    calls = []
    ring = SQ.ring_attention
    monkeypatch.setattr(SQ, "ring_attention",
                        lambda *a, **k: calls.append(1) or ring(*a, **k))
    with one_rank_group():
        from uurg_torch.parallel.mesh import make_mesh

        with SQ.sequence_parallel(make_mesh({"seq": 1})):
            with torch.no_grad():
                sampled = model(x, t, y)
            assert len(calls) == cfg.depth
            out = model(x, t, y)
            out.square().mean().backward()
    assert len(calls) == 3 * cfg.depth
    assert torch.equal(out, want) and torch.equal(sampled, want)
    for p, g in zip(model.parameters(), want_grads):
        torch.testing.assert_close(p.grad, g, atol=TOL, rtol=GRAD_RTOL)


def test_sd_attention_under_sp_two_ranks(setup):
    """SD's UNet under the context on seq=2: the self-attention that
    reaches the dispatcher (T % 128 == 0) all takes the ring, the rest
    (the 8 x 8 level, the cross-attention) stays local, and the output
    and gradients equal one process's."""
    one = PR.sd_attention_routes(setup.data["sd"], None)
    assert one["calls"]["dispatcher"] > 0 and one["calls"]["ring"] == 0
    for got in setup.two:
        g = got["sd_calls"]
        assert g["calls"] == {"dispatcher": one["calls"]["dispatcher"],
                              "ring": one["calls"]["dispatcher"]}
        np.testing.assert_allclose(g["out"].numpy(), one["out"].numpy(),
                                   atol=TOL, rtol=TOL)
        for k, w in one["grad"].items():
            np.testing.assert_allclose(g["grad"][k].numpy(), w.numpy(),
                                       atol=TOL, rtol=GRAD_RTOL, err_msg=k)


def test_dit_forget_and_nsfw_removal_under_sp_two_ranks(setup):
    """dit_forget (2 steps, AdamW, a packed mask) and nsfw_removal (one SGD
    step) under sp on seq=2 equal one process: parameters, EMA, Adam
    moments, metrics; the UNet file written once."""
    data = setup.data
    ref = PR.dit_runner_run(data["dit"], None, 2, None)
    sd_one = PR.sd_run(dict(data["sd"], tmp=str(setup.tmp)), None, "dp")
    moved = max(float((sd_one["params"][k] - data["sd"]["state"][k])
                      .abs().max()) for k in sd_one["params"])
    assert moved > 1e-5
    for got in setup.two:
        g = got["dit_forget"]
        for part in ("params", "ema"):
            for k, w in ref[part].items():
                np.testing.assert_allclose(g[part][k].numpy(), w.numpy(),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{part} {k}")
        for i, st in ref["opt"]["state"].items():
            np.testing.assert_allclose(g["opt"]["state"][i]["exp_avg"]
                                       .numpy(), st["exp_avg"].numpy(),
                                       rtol=RTOL, atol=ATOL)
        for a, b in zip(g["metrics"], ref["metrics"]):
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_REL,
                                           err_msg=k)
        s = got["nsfw_removal"]
        dev = max(float((s["params"][k] - sd_one["params"][k]).abs().max())
                  for k in sd_one["params"])
        assert dev < SD_PARAM_ABS
        assert s["packed"]
    assert sorted(p.name for p in (setup.tmp / "ranks").iterdir()) == [
        "sd_sp_sgd_2.pt"]
