"""The attention dispatcher's layouts (CPU): the bfloat16 kernels' layout
plan, its refusals, strided views against contiguous inputs, against the
JAX package, and DiT's MHSA on views against its old formulation that made
the heads contiguous.

The plan (``_bf16_plan``) is plain Python over shapes, strides and data
pointers, so it is held here to what the CUDA launchers are handed; the
kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.models.dit import MHSA  # noqa: E402
from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_tpu.ops.flash_attention import attention as jax_attention  # noqa: E402

# fp32 on both sides; only the summation order differs (tests/test_torch_ops.py)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
# gradients, fp32 on both sides: dS = P (dP - delta) cancels, and dk, dv sum
# T such terms in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (as in
    tests/test_torch_fisher.py): under pytest-xdist several workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fused(B, H, T, D, seed, dtype=torch.float32):
    """A seeded (B, T, 3, H, D) projection and a (B, T, H, D) gradient, as
    DiT's MHSA has them."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, H, D),
                                               dtype=np.float32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((B, T, H, D),
                                             dtype=np.float32)).to(dtype)
    return qkv, g


def _views(qkv):
    """q, k, v as MHSA.heads gives them: (B, H, T, D) views of qkv."""
    return tuple(t.transpose(1, 2) for t in qkv.unbind(2))


# -- (a) the plan -------------------------------------------------------------
PLAN_SHAPES = [(2, 2, 256, 72, 128), (2, 2, 77, 40, 64), (2, 2, 130, 160, 192),
               (2, 2, 256, 256, 256), (2, 2, 20, 20, 64)]


@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "views"])
@pytest.mark.parametrize("B,H,T,D,Dp", PLAN_SHAPES)
def test_bf16_plan(B, H, T, D, Dp, views):
    qkv, _ = _fused(B, H, T, D, seed=D, dtype=torch.bfloat16)
    ts = _views(qkv)
    if not views:
        ts = tuple(t.contiguous() for t in ts)
    plan = FA._bf16_plan(*ts)
    pad = D % 8 != 0
    width = Dp if pad else D
    assert (plan.Dp, plan.D, plan.width, plan.pad) == (Dp, D, width, pad)
    assert plan.Dp == FA._kernel_width(ts[0])
    dense = (width, T * width, H * T * width)
    # a pad copies into a fresh contiguous (B, H, T, Dp) tensor; otherwise
    # the kernels read each tensor through its own strides
    want = (3 * H * D, D, 3 * T * H * D) if views and not pad else dense
    assert plan.strides == (want,) * 3
    assert plan.token_major == (views and not pad)
    assert plan.out == ((H * width, width, T * H * width) if plan.token_major
                        else dense)
    # every stride the tensor maps get is a multiple of 16 bytes
    assert all(s * 2 % 16 == 0 for st in plan.strides + (plan.out,)
               for s in st)


def test_bf16_plan_covers_the_backward_tensors():
    qkv, g = _fused(2, 2, 64, 72, seed=1, dtype=torch.bfloat16)
    q, k, v = _views(qkv)
    o = torch.empty(2, 64, 2, 72, dtype=torch.bfloat16).transpose(1, 2)
    plan = FA._bf16_plan(q, k, v, o, g.transpose(1, 2))
    assert plan.strides == ((432, 72, 27648),) * 3 + ((144, 72, 9216),) * 2
    assert not plan.pad and plan.width == 72


def test_bf16_plan_length_one_dimensions_take_contiguous_strides():
    # H = 1 (the UNet's sites) and B = 1: strides a map never steps
    x = torch.zeros(1, 64, 1, 3 * 64, dtype=torch.bfloat16)
    q = x[..., :64].transpose(1, 2)            # (1, 1, 64, 64), T stride 192
    plan = FA._bf16_plan(q, q, q)
    assert plan.strides[0] == (192, 64 * 64, 64 * 64)
    assert not plan.token_major


# -- (b) refusals -------------------------------------------------------------
def _misaligned(shape):
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


@pytest.mark.parametrize("case", ["last_dim", "strides", "pointer"])
def test_plan_and_dispatcher_refuse_layouts_the_kernels_cannot_read(case):
    if case == "last_dim":
        t = torch.zeros(2, 2, 72, 256, dtype=torch.bfloat16).transpose(2, 3)
    elif case == "strides":                    # rows of 76 elements
        t = torch.zeros(2, 2, 256, 76, dtype=torch.bfloat16)[..., :72]
    else:                                      # 2 bytes past an alignment
        t = _misaligned((2, 2, 256, 72))
    assert t.shape == (2, 2, 256, 72)
    with pytest.raises(ValueError, match="contiguous"):
        FA._bf16_plan(t, t, t)
    with pytest.raises(ValueError, match="contiguous"):
        FA.attention(t, t, t)


def test_widths_not_a_multiple_of_8_are_padded_not_refused():
    # rows of 21 elements and an odd offset: the plan pads (a fresh
    # contiguous tensor), so only the last dimension's stride is checked
    t = torch.zeros(2, 2, 40, 21, dtype=torch.bfloat16)[..., :20]
    u = torch.zeros(2 * 2 * 40 * 20 + 1, dtype=torch.bfloat16)[1:] \
        .view(2, 2, 40, 20)
    for x in (t, u):
        plan = FA._bf16_plan(x, x, x)
        assert plan.pad and plan.width == 64
        assert plan.strides == ((64, 40 * 64, 2 * 40 * 64),) * 3
        assert FA.attention(x, x, x).shape == x.shape


# -- (c) views against contiguous inputs on the CPU path ---------------------
def _run(qkv, g, views: bool):
    """Output and the gradient of the fused projection, with q, k, v the
    views or contiguous copies of them (and g token-major or contiguous)."""
    base = qkv.clone().requires_grad_()
    ts = _views(base)
    gt = g.transpose(1, 2)
    if not views:
        ts = tuple(t.contiguous() for t in ts)
        gt = gt.contiguous()
    o = FA.attention(*ts)
    o.backward(gt)
    return o.detach(), base.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [40, 72, 160])
def test_cpu_path_views_equal_contiguous(D, dtype):
    """Bit for bit: on the CPU the plain versions widen q, k and v to fp32
    (a dense copy for bf16, the view itself for fp32), and torch's CPU
    matrix products pack a strided operand into the same blocks as a
    contiguous one, so the sums run in the same order (measured here at two
    threads, the fixture's)."""
    qkv, g = _fused(2, 2, 77, D, seed=D, dtype=dtype)
    launches = FA.attention.launches, FA.attention_bwd.launches
    o_v, d_v = _run(qkv, g, views=True)
    o_c, d_c = _run(qkv, g, views=False)
    assert (FA.attention.launches, FA.attention_bwd.launches) == launches
    assert o_v.dtype == dtype and o_v.shape == (2, 2, 77, D)
    assert torch.equal(o_v, o_c)
    assert torch.equal(d_v, d_c)


# -- (d) views against the JAX package ---------------------------------------
def test_views_match_jax_attention():
    B, H, T, D = 2, 2, 256, 72
    qkv, g = _fused(B, H, T, D, seed=7)
    base = qkv.clone().requires_grad_()
    o = FA.attention(*_views(base))
    o.backward(g.transpose(1, 2))
    qn, kn, vn = (np.ascontiguousarray(t.numpy())
                  for t in _views(qkv))
    gn = np.ascontiguousarray(g.transpose(1, 2).numpy())
    # the JAX dispatcher off the TPU (its XLA reference), with its gradient
    ref, vjp = jax.vjp(jax_attention, jnp.asarray(qn), jnp.asarray(kn),
                       jnp.asarray(vn))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref),
                               **ATTN_TOL)
    dq, dk, dv = (np.asarray(a) for a in vjp(jnp.asarray(gn)))
    want = np.stack([dq, dk, dv], axis=1).transpose(0, 3, 1, 2, 4)
    np.testing.assert_allclose(base.grad.numpy(), want, **GRAD_TOL)
    # and the Pallas kernel in interpret mode (D = 72 padded to 128 there)
    pallas = jax_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                           use_pallas=True, interpret=True)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(pallas),
                               **ATTN_TOL)


# -- (e) DiT's MHSA on views against the old formulation ---------------------
class _ContiguousHeads(MHSA):
    """MHSA as it was: the heads made contiguous from the projection."""

    def heads(self, x):
        B, T, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, T, 3, H, D // H)
        return tuple(qkv[:, :, i].transpose(1, 2).contiguous()
                     for i in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mhsa_views_equal_contiguous_heads(dtype):
    """Output, input gradient and weight gradients bit-equal on the CPU, for
    the reason of test_cpu_path_views_equal_contiguous."""
    dim, heads, T = 144, 2, 64                 # head width 72, as DiT-XL/2
    torch.manual_seed(0)
    new = MHSA(dim, heads, dtype)
    old = _ContiguousHeads(dim, heads, dtype)
    old.load_state_dict(new.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, T, dim), dtype=np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, T, dim), dtype=np.float32))
    outs = []
    for m in (new, old):
        xi = x.clone().to(dtype).requires_grad_()
        y = m(xi)
        y.backward(gy.to(y.dtype))
        outs.append((y.detach(), xi.grad,
                     *(p.grad for p in m.parameters())))
    q, k, v = new.heads(x.to(dtype))
    assert q._base is not None and not q.is_contiguous()   # views, no copy
    for a, b in zip(*outs):
        assert torch.equal(a, b)
