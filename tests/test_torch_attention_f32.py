"""The float32 route of the attention dispatcher (CPU): the plain versions
against the JAX package's Pallas kernels in interpret mode at float32 (the
configuration the ViT classifiers give them), the dispatcher's counters and
the widths and dtypes the CUDA kernels take. The kernels themselves are held
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 16)."""
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
    with pytest.raises(ValueError, match="head width"):
        FA._kernel_width(torch.empty(1, 1, 4, 320))
