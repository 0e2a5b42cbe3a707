"""The float32 route of the attention dispatcher (CPU): the plain versions
against the JAX package's Pallas kernels in interpret mode at float32 (the
configuration the ViT classifiers give them), the dispatcher's counters,
the widths and dtypes the CUDA kernels take, the route plan of the float32
kernels, and models of the packed and key-tiled routes' decompositions
against the plain versions. The kernels themselves are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_tpu.ops.flash_attention import fused_attention  # noqa: E402

# float32 on both sides, the sums in another order: relative L2 of the
# output, and of each gradient (the backward sums T products of P (dP - delta)
# terms, which cancel where dP is close to delta)
FWD_REL, BWD_REL = 1e-5, 1e-4


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


def _inputs(T, D, seed, B=2, H=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D), dtype=np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("D", [64, 40])
def test_f32_plain_matches_pallas_interpret(D):
    q, k, v, g = _inputs(128, D, D)
    want, vjp = jax.vjp(
        lambda a, b, c: fused_attention(a, b, c, 128, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    got = FA.attention_plain(tq, tk, tv)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= FWD_REL
    for name, a, b in zip("qkv", FA.attention_bwd_plain(tq, tk, tv, tg),
                          want_grads):
        assert a.dtype == torch.float32, name
        assert _rel(a.numpy(), b) <= BWD_REL, name


def test_f32_dispatcher_on_cpu_counts_nothing():
    q, k, v, g = _inputs(16, 64, 1)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (FA.attention.launches, FA.attention.launches_f32,
              FA.attention_bwd.launches, FA.attention_bwd.launches_f32)
    out = FA.attention(*ts)
    out.backward(torch.from_numpy(g))
    assert (FA.attention.launches, FA.attention.launches_f32,
            FA.attention_bwd.launches,
            FA.attention_bwd.launches_f32) == before
    want = FA.attention_bwd_plain(*(torch.from_numpy(a)
                                    for a in (q, k, v, g)))
    for t, w in zip(ts, want):
        np.testing.assert_array_equal(t.grad.numpy(), w.numpy())


def test_f64_gradients_are_float64_throughout():
    # float64 inputs are the precision references (chip_smoke.py phase 17
    # measures each side's distance from a float64 ViT): the backward of the
    # dispatcher must then be float64 too, not a float32 pass cast back
    q, k, v, g = (a.astype(np.float64) for a in _inputs(16, 40, 2))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    FA.attention(*ts).backward(torch.from_numpy(g))
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    FA.attention_plain(*ref).backward(torch.from_numpy(g))
    for name, t, r in zip("qkv", ts, ref):
        assert t.grad.dtype == torch.float64, name
        assert _rel(t.grad.numpy(), r.grad.numpy()) <= 1e-12, name


@pytest.mark.parametrize("D,Dp", [(64, 64), (40, 64), (160, 192), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_width_takes_f32_and_bf16(dtype, D, Dp):
    assert FA._kernel_width(torch.empty(1, 1, 4, D, dtype=dtype)) == Dp


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_width_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        FA._kernel_width(torch.empty(1, 1, 4, 64, dtype=dtype))


def test_kernel_width_refuses_wide_heads():
    # float32 takes widths up to 512 (a forward only), bfloat16 up to 256
    with pytest.raises(ValueError, match="head width"):
        FA._kernel_width(torch.empty(1, 1, 4, 576))
    with pytest.raises(NotImplementedError, match="head width 320"):
        FA._kernel_width(torch.empty(1, 1, 4, 320, dtype=torch.bfloat16))


# -- the float32 kernels' route plan ----------------------------------------

@pytest.mark.parametrize("T,route,scratch", [
    (5, "packed", None), (16, "packed", None),
    (17, "tiled", (64 * 12, 64, 64)),
    (197, "tiled", (64 * 12, 256, 256)),
    (1024, "tiled", (64 * 12, 1024, 1024))])
def test_f32_plan_route_and_scratch(T, route, scratch):
    assert FA._f32_plan(64, 12, T, 64) == (route, scratch)


@pytest.mark.parametrize("D", [40, 64, 72, 160, 192, 256])
@pytest.mark.parametrize("T", [5, 197])
def test_f32_plan_routes_by_the_kernels_width(T, D):
    # the padded widths the tiled and packed kernels do not take (above 64)
    # go to the wide route, and only those
    route = FA._f32_plan(2, 3, T, D).route
    width = FA._kernel_width(torch.empty(1, 1, T, D))
    assert route in FA._F32_ROUTES
    assert (route == "wide") == (width > 64)


@pytest.mark.parametrize("shape", [(1, 1, 4, 576), (1, 1, 0, 64),
                                   (0, 2, 16, 64), (1, 1, 16, 0)])
def test_f32_plan_refuses_what_the_kernels_refuse(shape):
    with pytest.raises(ValueError):
        FA._f32_plan(*shape)


def _heads(B, H, T, D, seed):
    return [torch.from_numpy(a.astype(np.float64))
            for a in _inputs(T, D, seed, B=B, H=H)]


@pytest.mark.parametrize("T", [1, 3, 5, 16])
def test_packed_chunks_are_per_head_attention(T):
    """The packed route's layout: (B*H, T, D) heads lie back to back, so a
    chunk of floor(16 / T) heads is one run of rows of the flat (B*H*T, D)
    array, and attention over a chunk with a block-diagonal mask (and the
    last chunk's missing heads left out) is each head's own attention.
    B*H = 7 leaves the last chunk short but for T = 1 and 16."""
    q, k, v, g = _heads(7, 1, T, 40, T)
    plan = FA._f32_plan(7, 1, T, 40)
    assert plan.route == "packed"
    G = FA._PACK_T // T
    flat = [t.reshape(-1, 40) for t in (q, k, v)]
    out = torch.empty_like(flat[0])
    for r0 in range(0, 7 * T, G * T):
        qc, kc, vc = (t[r0:r0 + G * T] for t in flat)
        head = torch.arange(qc.shape[0]) // T
        s = qc @ kc.T * 40 ** -0.5
        s = s.masked_fill(head[:, None] != head[None, :], float("-inf"))
        out[r0:r0 + G * T] = torch.softmax(s, -1) @ vc
    want = FA.attention_plain(q, k, v)
    assert _rel(out.reshape(want.shape).numpy(), want.numpy()) <= 1e-12


@pytest.mark.parametrize("T", [17, 65, 197])
def test_tiled_backward_from_key_tiles_and_the_ds_scratch(T):
    """The tiled backward's decomposition: a 64-key tile's dk and dv need
    only its own columns of dS and P over all query tiles of 32, which it
    writes as rows of the plan's dS^T scratch ([head][key][query], T padded
    to Tp, the padding never read); dq = dS K summed from the scratch over
    32-key tiles in order is the plain version's dq."""
    q, k, v, g = _heads(2, 3, T, 64, T)
    BH, Tp, Tp2 = FA._f32_plan(2, 3, T, 64).scratch
    assert (BH, Tp) == (6, Tp2) and Tp >= T and Tp % 64 == 0
    scale = 64 ** -0.5
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, -1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    scratch = torch.full((BH, Tp, Tp), float("nan"), dtype=torch.float64)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, T, 64):
        ks = slice(k0, min(k0 + 64, T))
        dk[..., ks, :] = ds[..., ks].transpose(-1, -2) @ q
        dv[..., ks, :] = p[..., ks].transpose(-1, -2) @ g
        for q0 in range(0, T, 32):
            qs = slice(q0, min(q0 + 32, T))
            scratch[:, ks, qs] = ds[..., qs, ks].transpose(-1, -2).reshape(
                BH, ks.stop - k0, qs.stop - q0)
    dq = torch.zeros(BH, T, 64, dtype=torch.float64)
    kf = k.reshape(BH, T, 64)
    for k0 in range(0, T, 32):
        ks = slice(k0, min(k0 + 32, T))
        dq = dq + scratch[:, ks, :T].transpose(-1, -2) @ kf[:, ks]
    want = FA.attention_bwd_plain(q, k, v, g)
    for name, got, w in zip("qkv", (dq.reshape(q.shape), dk, dv), want):
        assert _rel(got.numpy(), w.numpy()) <= 1e-12, name
