"""The port's attention and GroupNorm gradients vs the JAX package (CPU,
fp32): the plain backward versions and the autograd Functions' CPU
backward, against ``jax.vjp`` of the XLA reference formulations and against
the Pallas backward kernels run in interpret mode."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.ops.flash_attention import (  # noqa: E402
    attention,
    attention_bwd,
    attention_bwd_plain,
)
from uurg_torch.ops.group_norm import (  # noqa: E402
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_plain,
)
from uurg_tpu.ops.flash_attention import (  # noqa: E402
    _fused_attention_bwd_impl,
    _reference_attention,
)
from uurg_tpu.ops.group_norm import _gn_reference, fused_group_norm  # noqa: E402

# fp32 on both sides: the products are the same, summed in another order
# (T or B*H*W terms) -> relative error ~1e-6; 1e-4 leaves room for the
# cancellation in dS = P (dP - delta) and in GN's gs - s1 - x_hat * s2
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
GN_TOL = dict(rtol=1e-4, atol=1e-4)


def _attn_inputs(T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 1, T, D), dtype=np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("T,D", [(16, 64), (128, 64), (256, 64), (16, 256),
                                 (128, 256), (256, 256), (128, 40)])
def test_attention_bwd_matches_jax(T, D):
    q, k, v, g = _attn_inputs(T, D, T * 1000 + D)
    _, vjp = jax.vjp(_reference_attention, q, k, v)
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    pallas = [np.asarray(a) for a in _fused_attention_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        block_q=min(128, T), interpret=True)]

    plain = attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, g)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    launches = (attention.launches, attention_bwd.launches)
    attention(*ts).backward(torch.from_numpy(g))
    assert (attention.launches, attention_bwd.launches) == launches
    for name, p, t, r, pl in zip("qkv", plain, ts, ref, pallas):
        np.testing.assert_allclose(p.numpy(), r, err_msg=name, **ATTN_TOL)
        np.testing.assert_allclose(p.numpy(), pl, err_msg=name, **ATTN_TOL)
        np.testing.assert_array_equal(t.grad.numpy(), p.numpy())


@pytest.mark.parametrize("T,D", [(77, 40), (100, 72), (130, 160), (256, 192)])
def test_attention_bwd_matches_jax_at_ragged_shapes(T, D):
    """T that no tile size divides and head widths that the CUDA wrapper
    pads: the plain backward and the Function's CPU backward against the
    VJP of the JAX package's reference formulation (fp32, ATTN_TOL)."""
    q, k, v, g = _attn_inputs(T, D, T * 1000 + D)
    _, vjp = jax.vjp(_reference_attention, q, k, v)
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    plain = attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, g)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    launches = (attention.launches, attention_bwd.launches)
    attention(*ts).backward(torch.from_numpy(g))
    assert (attention.launches, attention_bwd.launches) == launches
    direct = attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(q), None, torch.from_numpy(g))
    for name, p, t, d, r in zip("qkv", plain, ts, direct, ref):
        assert p.shape == (2, 1, T, D), name
        np.testing.assert_allclose(p.numpy(), r, err_msg=name, **ATTN_TOL)
        np.testing.assert_array_equal(t.grad.numpy(), p.numpy())
        np.testing.assert_array_equal(d.numpy(), p.numpy())


def test_attention_function_takes_gradient_in_any_stride_order():
    q, k, v, g = _attn_inputs(16, 64, 5)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention(*ts)
    # the gradient arrives through a transpose, as from a layout change
    (out.transpose(2, 3) * torch.from_numpy(g).transpose(2, 3)).sum().backward()
    want = attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, g)))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), **ATTN_TOL)


def _gn_inputs(C, seed, H=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, H, H, C), dtype=np.float32) * 2 + 0.3
    scale = rng.standard_normal(C, dtype=np.float32) * 0.1 + 1.0
    bias = rng.standard_normal(C, dtype=np.float32) * 0.1
    g = rng.standard_normal((3, H, H, C), dtype=np.float32)
    return x, scale, bias, g


# (C, groups, H = W): the 8x8 cases, then H W not a multiple of the
# backward kernel's cluster (slices of unequal length; at C = 384 a 16-byte
# chunk straddles groups of 12): the CPU path must not depend on either
@pytest.mark.parametrize("C,groups,H", [
    pytest.param(64, 32, 8, id="64-32"), pytest.param(128, 32, 8, id="128-32"),
    pytest.param(384, 32, 8, id="384-32"), pytest.param(24, 8, 8, id="24-8"),
    pytest.param(128, 32, 5, id="128-32-H5"),
    pytest.param(384, 32, 12, id="384-32-H12")])
def test_group_norm_bwd_matches_jax(C, groups, H):
    x, scale, bias, g = _gn_inputs(C, C, H)
    _, vjp = jax.vjp(lambda a, s, b: _gn_reference(a, s, b, groups, 1e-6),
                     x, scale, bias)
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    _, vjp_p = jax.vjp(
        lambda a, s, b: fused_group_norm(a, s, b, groups, 1e-6, True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    pallas = [np.asarray(a) for a in vjp_p(jnp.asarray(g))]

    xt, st, bt, gt = (torch.from_numpy(a) for a in (x, scale, bias, g))
    _, mean, rstd = group_norm_plain(xt, st, bt, groups, 1e-6, True)
    plain = group_norm_bwd_plain(xt, st, mean, rstd, gt)
    ts = [a.clone().requires_grad_() for a in (xt, st, bt)]
    launches = (group_norm.launches, group_norm_bwd.launches)
    # groups=32 is halved to 8 for C=24 inside the dispatcher
    group_norm(*ts, groups=32).backward(gt)
    assert (group_norm.launches, group_norm_bwd.launches) == launches
    for name, p, t, r, pl in zip(("x", "scale", "bias"), plain, ts, ref,
                                 pallas):
        np.testing.assert_allclose(p.numpy(), r, err_msg=name, **GN_TOL)
        np.testing.assert_allclose(p.numpy(), pl, err_msg=name, **GN_TOL)
        np.testing.assert_array_equal(t.grad.numpy(), p.numpy())


def test_group_norm_bwd_refuses_mismatched_inputs():
    x, scale, bias, g = (torch.from_numpy(a) for a in _gn_inputs(64, 1))
    _, mean, rstd = group_norm_plain(x, scale, bias, 32, 1e-6, True)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        group_norm_bwd(x, scale, mean, rstd, g.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous NHWC"):
        group_norm_bwd(x, scale, mean, rstd, g.double())
    with pytest.raises(ValueError, match="statistics"):
        group_norm_bwd(x, scale, mean[:, :16].contiguous(), rstd, g)
