"""uurg_torch kernels on the card against their plain versions (bf16).

Marked ``cuda``: each test skips without a CUDA device. On a GPU machine:
``python -m pytest tests/test_torch_cuda.py -q -m cuda``.
"""
import pytest

torch = pytest.importorskip("torch")

from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_torch.ops import group_norm as GN  # noqa: E402
from uurg_torch.ops.flash_attention import (  # noqa: E402
    attention,
    attention_bwd,
    attention_bwd_plain,
    attention_plain,
)
from uurg_torch.ops.group_norm import (  # noqa: E402
    group_norm,
    group_norm_bwd,
    group_norm_bwd_plain,
    group_norm_plain,
)

pytestmark = pytest.mark.cuda

# both sides round their output to bf16 after fp32 arithmetic in another
# order: one to two output roundings (relative 2**-8 each)
ATOL, RTOL = 1e-2, 1e-2
# backward kernels in bf16: dk and dv are sums over T and dq over the keys,
# so they are held to their norm. Both sides round P and dS to bf16 before
# the products and round each gradient once; the kernel takes delta from
# the bf16 forward output where the plain version sums P * dP in fp32.
BWD_REL_L2 = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# the UNet's two sites, then the shapes off the main path that chip_smoke.py
# holds too: ragged T (TMA zero fill, key masking) and padded head widths
SHAPES = [(16, 256), (256, 256), (100, 64), (130, 192), (16, 72), (77, 40),
          (100, 72), (130, 160), (256, 192), (1024, 64), (1024, 256)]


@pytest.mark.parametrize("T,D", SHAPES)
def test_attention_kernel_matches_plain(gen, T, D):
    q, k, v = (torch.randn(4, 2, T, D, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = attention.launches
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


# (batch, H = W, C): sites of the UNet, narrow channels with halved groups,
# then the shapes off the main path that chip_smoke.py holds too: H W not a
# multiple of the cluster (slices of unequal length), a sample too large
# for a cluster in fp32 (the sweep route), batch 1 and 2, and a single pixel.
# Each runs on the wrapper's route, on sweep and at every cluster that fits
GN_SHAPES = [(3, 32, 128), (3, 16, 384), (3, 4, 512), (3, 8, 24), (3, 4, 256),
             (3, 32, 384), (3, 5, 256), (3, 12, 384), (3, 32, 512),
             (1, 16, 256), (1, 1, 64), (3, 21, 384), (2, 29, 640)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,C", GN_SHAPES)
def test_group_norm_kernel_matches_plain(gen, dtype, B, H, C):
    x = (torch.randn(B, H, H, C, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.2
    before = group_norm.launches
    got, mean, rstd = group_norm(x, scale, bias, return_stats=True)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    groups = mean.shape[1]
    want, mean_p, rstd_p = group_norm_plain(x, scale, bias, groups, 1e-6, True)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.bfloat16 else \
        dict(atol=1e-5, rtol=1e-5)
    chosen = GN._fwd_route(H * H, C, x.element_size(), groups)
    fit = [("slab", s) for s in GN._CLUSTERS if s < H * H
           and C * x.element_size() % 16 == 0
           and GN._slab_smem(H * H, C, x.element_size(), groups, s)
           <= GN._SMEM_MAX]
    for route in dict.fromkeys([chosen, ("sweep", 1)] + fit):
        out = GN._group_norm_kernel(x, scale, bias, groups, 1e-6, route=route)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[0].float(), want.float(), **tol)
        torch.testing.assert_close(out[1], mean_p, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(out[2], rstd_p, atol=1e-4, rtol=1e-4)
        if route == chosen:                          # what group_norm ran
            assert all(torch.equal(a, b)
                       for a, b in zip(out, (got, mean, rstd)))
        for _ in range(2):                           # no atomics: same bits
            again = GN._group_norm_kernel(x, scale, bias, groups, 1e-6,
                                          route=route)
            assert all(torch.equal(a, b) for a, b in zip(out, again))


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("T,D", SHAPES)
def test_attention_bwd_kernel_matches_plain(gen, T, D):
    q, k, v, g = (torch.randn(4, 2, T, D, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
    o = o.contiguous()                               # a column slice at D = 40
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(-1, T),
                               atol=1e-4, rtol=1e-4)
    before = attention_bwd.launches
    got = attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    for name, a, b in zip("qkv", got, attention_bwd_plain(q, k, v, g)):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert _rel_l2(a, b) < BWD_REL_L2, name
    for _ in range(2):                               # no atomics: same bits
        again = attention_bwd(q, k, v, o, lse, g)
        o2, lse2 = FA._attention_kernel(q, k, v, with_lse=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert torch.equal(o2.contiguous(), o) and torch.equal(lse2, lse)


def test_attention_autograd_uses_both_kernels(gen):
    q, k, v = (torch.randn(2, 1, 256, 256, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    fwd, bwd = attention.launches, attention_bwd.launches
    out = attention(q, k, v)
    g = torch.randn_like(out)
    out.backward(g)
    torch.cuda.synchronize()
    assert (attention.launches, attention_bwd.launches) == (fwd + 1, bwd + 1)
    want = attention_bwd_plain(q.detach(), k.detach(), v.detach(), g)
    for t, w in zip((q, k, v), want):
        assert _rel_l2(t.grad, w) < BWD_REL_L2


# the forward's shapes, then batches whose dscale and dbias fold over more
# than one group of rows (the second level of the batch fold)
GN_BWD_SHAPES = GN_SHAPES + [(128, 4, 256), (256, 8, 512), (40, 16, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,C", GN_BWD_SHAPES)
def test_group_norm_bwd_kernel_matches_plain(gen, dtype, B, H, C):
    x = (torch.randn(B, H, H, C, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    g = torch.randn(B, H, H, C, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.2
    _, mean, rstd = group_norm(x, scale, bias, return_stats=True)
    groups = mean.shape[1]
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, scale, mean, rstd, g)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 1          # one launch a call
    dx, dscale, dbias = group_norm_bwd_plain(x, scale, mean, rstd, g)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=1e-4)
    size = x.element_size()
    chosen = GN._bwd_route(H * H, C, size, groups)
    fit = [("slab", s) for s in GN._CLUSTERS if s < H * H
           and C * size % 16 == 0
           and GN._bwd_slab_smem(H * H, C, size, groups, s) <= GN._SMEM_MAX]
    for route in dict.fromkeys([chosen, ("sweep", 1)] + fit):
        out = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g, route=route)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[0].float(), dx.float(), **tol)
        # fp32 sums over batch and space of identical products, in another
        # order
        torch.testing.assert_close(out[1], dscale, atol=1e-3, rtol=1e-4)
        torch.testing.assert_close(out[2], dbias, atol=1e-3, rtol=1e-4)
        if route == chosen:                          # what group_norm_bwd ran
            assert all(torch.equal(a, b) for a, b in zip(out, got))
        for _ in range(2):           # no float atomics: same bits every run
            again = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g,
                                              route=route)
            assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert int(GN._fold_counters[x.device].abs().sum()) == 0   # left zero


def test_group_norm_autograd_uses_both_kernels(gen):
    x = torch.randn(2, 16, 16, 256, generator=gen, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()
    scale = torch.ones(256, device="cuda", requires_grad=True)
    bias = torch.zeros(256, device="cuda", requires_grad=True)
    fwd, bwd = group_norm.launches, group_norm_bwd.launches
    y = group_norm(x, scale, bias)
    g = torch.randn_like(y)
    y.backward(g)
    torch.cuda.synchronize()
    assert (group_norm.launches, group_norm_bwd.launches) == (fwd + 1, bwd + 1)
    _, mean, rstd = group_norm_plain(x.detach(), scale.detach(), bias.detach(),
                                     32, 1e-6, True)
    want = group_norm_bwd_plain(x.detach(), scale.detach(), mean, rstd, g)
    for t, w in zip((x, scale, bias), want):
        assert _rel_l2(t.grad, w) < BWD_REL_L2


def test_sampling_path_saves_nothing_for_backward(gen):
    q = torch.randn(2, 1, 16, 256, generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    with torch.inference_mode():
        out = attention(q, q, q)
    assert out.grad_fn is None


def test_backward_kernels_at_the_ragged_fisher_batch(gen):
    """The last remain batch of the Fisher pass on the stand-in, doubled by
    the CFG forward: batch 124 (not a multiple of the GroupNorm backward's
    16-sample fold groups), at both attention sites and three GroupNorm
    site shapes of the full-width UNet."""
    for T in (256, 16):
        q, k, v, g = (torch.randn(124, 1, T, 256, generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(4))
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        got = attention_bwd(q, k, v, o, lse, g)
        torch.cuda.synchronize()
        for name, a, b in zip("qkv", got, attention_bwd_plain(q, k, v, g)):
            assert _rel_l2(a, b) < BWD_REL_L2, (T, name)
        again = attention_bwd(q, k, v, o, lse, g)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    for H, C in ((32, 128), (16, 256), (4, 512)):
        x = (torch.randn(124, H, H, C, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        g = torch.randn(124, H, H, C, generator=gen,
                        device="cuda").to(torch.bfloat16)
        scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
        _, mean, rstd = group_norm(x, scale, scale, return_stats=True)
        got = group_norm_bwd(x, scale, mean, rstd, g)
        torch.cuda.synchronize()
        dx, dscale, dbias = group_norm_bwd_plain(x, scale, mean, rstd, g)
        torch.testing.assert_close(got[0].float(), dx.float(), atol=ATOL,
                                   rtol=RTOL)
        torch.testing.assert_close(got[1], dscale, atol=1e-3, rtol=1e-4)
        torch.testing.assert_close(got[2], dbias, atol=1e-3, rtol=1e-4)
        again = group_norm_bwd(x, scale, mean, rstd, g)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert int(GN._fold_counters[x.device].abs().sum()) == 0   # left zero


# the float32 route (the ViT classifiers): ViT-B/16 at 224 and 32 px, padded
# head widths, then the ragged shapes above at D in {40, 72, 160, 192}
F32_SHAPES = [(4, 12, 197, 64), (8, 12, 5, 64), (2, 12, 197, 40),
              (2, 12, 197, 160)] + [(2, 2, T, D) for T, D in SHAPES[4:]]


@pytest.mark.parametrize("B,H,T,D", F32_SHAPES)
def test_attention_f32_kernels_match_plain(gen, B, H, T, D):
    """float32 on both sides (TF32 off): relative L2 1e-5 forward and 1e-4
    backward, as chip_smoke.py phase 16; one launch of each on its own
    counter and none on the bf16 counters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                  for _ in range(4))
    counts = (attention.launches, attention.launches_f32,
              attention_bwd.launches, attention_bwd.launches_f32)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention(*ts)
    out.backward(g)
    torch.cuda.synchronize()
    assert (attention.launches, attention.launches_f32,
            attention_bwd.launches, attention_bwd.launches_f32) == (
        counts[0], counts[1] + 1, counts[2], counts[3] + 1)

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    assert out.dtype == torch.float32
    assert rel(out, attention_plain(q, k, v)) <= 1e-5
    for t, w in zip(ts, attention_bwd_plain(q, k, v, g)):
        assert rel(t.grad, w) <= 1e-4
