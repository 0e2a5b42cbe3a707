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
# for a cluster in fp32 (the split route), batch 1 and 2, and a single pixel.
# Each runs on the wrapper's route, on split (the wrapper's count of runs a
# sample and one run) and at every cluster that fits
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
    chosen = GN._fwd_route(H * H, C, x.element_size(), groups, B)
    fit = [("slab", s) for s in GN._CLUSTERS if s < H * H
           and C * x.element_size() % 16 == 0
           and GN._slab_smem(H * H, C, x.element_size(), groups, s)
           <= GN._SMEM_MAX]
    split = ("split", GN._split_count(B, H * H, C, x.element_size()))
    for route in dict.fromkeys([chosen, split, ("split", 1)] + fit):
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


# the split route where the wrapper takes it: the VAE's batch 32 (fp32,
# 17 runs a sample), SD's bf16 sites at batch 1 and 4 (264 and 132 runs), a
# one-pixel sample at batch 1, 4 and 32, and a sample of 225 pixels of 8 KB
# cut into runs of one pixel
SPLIT_SHAPES = [(32, 32, 32, 512, torch.float32), (4, 64, 64, 320, torch.bfloat16),
                (1, 32, 32, 1280, torch.bfloat16), (4, 32, 32, 1920, torch.bfloat16),
                (1, 1, 1, 64, torch.float32), (4, 1, 1, 512, torch.bfloat16),
                (32, 1, 1, 512, torch.float32), (1, 15, 15, 4096, torch.bfloat16),
                (2, 512, 512, 128, torch.float32), (4, 64, 64, 512, torch.float32)]


@pytest.mark.parametrize("B,H,W,C,dtype", SPLIT_SHAPES)
def test_group_norm_split_route_matches_plain(gen, B, H, W, C, dtype):
    x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.2
    route = GN._fwd_route(H * W, C, x.element_size(), 32, B)
    assert route[0] == "split"
    before = group_norm.launches
    got = group_norm(x, scale, bias, return_stats=True)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1          # one call, two kernels
    want = group_norm_plain(x, scale, bias, 32, 1e-6, True)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.bfloat16 else \
        dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=1e-4)
    for _ in range(2):                                 # no atomics: same bits
        again = group_norm(x, scale, bias, return_stats=True)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("T,D", SHAPES)
def test_attention_bwd_kernel_matches_plain(gen, T, D):
    q, k, v, g = (torch.randn(4, 2, T, D, generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
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
        assert torch.equal(o2, o) and torch.equal(lse2, lse)


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
    chosen = GN._bwd_route(H * H, C, size, groups, B)
    fit = [("slab", s) for s in GN._CLUSTERS if s < H * H
           and C * size % 16 == 0
           and GN._bwd_slab_smem(H * H, C, size, groups, s) <= GN._SMEM_MAX]
    split = [("split", GN._bwd_split_count(B, H * H, C, size)), ("split", 1)]
    for route in dict.fromkeys([chosen] + split + fit):
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
# head widths, then the ragged shapes above at D in {40, 72, 160, 192}, then
# the edges of the packed and tiled routes (chip_smoke.py F32_EDGE_T) at
# D = 64 and padded from 40
F32_SHAPES = ([(4, 12, 197, 64), (8, 12, 5, 64), (2, 12, 197, 40),
               (2, 12, 197, 160)] + [(2, 2, T, D) for T, D in SHAPES[4:]]
              + [(2, 3, T, D) for T in (5, 16, 17, 31, 33, 63, 65, 196, 197,
                                        208) for D in (64, 40)])


@pytest.mark.parametrize("B,H,T,D", F32_SHAPES)
def test_attention_f32_kernels_match_plain(gen, B, H, T, D):
    """float32 on both sides (TF32 off): relative L2 1e-5 forward and 1e-4
    backward, as chip_smoke.py phase 16, and the same bits from two more
    runs; one launch of each on its own counter and none on the bf16
    counters."""
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
    for _ in range(2):
        again = [t.clone().requires_grad_() for t in (q, k, v)]
        out2 = attention(*again)
        out2.backward(g)
        assert torch.equal(out2, out)
        assert all(torch.equal(a.grad, t.grad) for a, t in zip(again, ts))


# DiT-XL/2's attention: T = 256 tokens, 16 heads of width 72 (the bf16
# kernels' true width; the fp32 dispatcher pads it to 128), at the training
# batch 32 in bf16 and at the fp32 card-vs-CPU check's batch 2 (the wide
# route), as chip_smoke.py phase 18
DIT_SHAPES = [(torch.bfloat16, (32, 16, 256, 72)),
              (torch.float32, (2, 16, 256, 72))]


@pytest.mark.parametrize("dtype,shape", DIT_SHAPES)
def test_attention_kernels_at_the_dit_shape(gen, dtype, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda",
                              dtype=dtype) for _ in range(4))
    f32 = dtype == torch.float32
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    counts = (attention.launches_f32 if f32 else attention.launches,
              attention_bwd.launches_f32 if f32 else attention_bwd.launches)
    out = attention(*ts)
    out.backward(g)
    torch.cuda.synchronize()
    assert ((attention.launches_f32 if f32 else attention.launches),
            (attention_bwd.launches_f32 if f32 else attention_bwd.launches)
            ) == (counts[0] + 1, counts[1] + 1)
    assert out.shape == shape and out.dtype == dtype
    if f32:
        assert _rel_l2(out, attention_plain(q, k, v)) <= 1e-5
    else:
        torch.testing.assert_close(out.float(),
                                   attention_plain(q, k, v).float(),
                                   atol=ATOL, rtol=RTOL)
    for t, w in zip(ts, attention_bwd_plain(q, k, v, g)):
        assert _rel_l2(t.grad, w) <= (1e-4 if f32 else BWD_REL_L2)
    again = [t.clone().requires_grad_() for t in (q, k, v)]
    out2 = attention(*again)
    out2.backward(g)
    assert torch.equal(out2, out)
    assert all(torch.equal(a.grad, t.grad) for a, t in zip(again, ts))


@pytest.mark.parametrize("policy", [None, "attn"])
def test_dit_launches_the_kernels_per_remat_policy(gen, policy):
    """A 2-block DiT at head width 72 (T = 256) in bf16, perturbed so its
    adaLN gates are non-zero: the output against its plain path, and one
    attention forward a block (two under full remat) and one backward in
    a training step."""
    from uurg_torch.models import dit as TD

    cfg = TD.DiTConfig(input_size=32, patch_size=2, hidden_size=144,
                       depth=2, num_heads=2, num_classes=10,
                       remat_policy=policy)
    model = TD.init_dit(0, cfg, "cuda")
    with torch.no_grad():
        for p in model.parameters():
            std = 0.5 / p[0].numel() ** 0.5 if p.ndim >= 2 else 0.05
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * std)
    x = torch.randn(4, 32, 32, 4, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (4,), generator=gen, device="cuda")
    y = torch.randint(0, 10, (4,), generator=gen, device="cuda")
    fwd, bwd = attention.launches, attention_bwd.launches
    out = model(x, t, y)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    per_block = 2 if policy is None else 1
    assert attention.launches - fwd == per_block * cfg.depth
    assert attention_bwd.launches - bwd == cfg.depth
    kernel = TD.attention
    TD.attention = attention_plain
    try:
        with torch.no_grad():
            want = model(x, t, y)
    finally:
        TD.attention = kernel
    assert _rel_l2(out.detach(), want) < 2e-2


def _mhsa_views(B, H, T, D, gen):
    """q, k, v as (B, H, T, D) views of one fused (B, T, 3, H, D)
    projection and g as a view of a token-major (B, T, H, D) gradient: the
    layout DiT's MHSA hands the dispatcher."""
    qkv = torch.randn(B, T, 3, H, D, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    g = torch.randn(B, T, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    return (*(t.transpose(1, 2) for t in qkv.unbind(2)), g.transpose(1, 2))


def _fwd_bwd(q, k, v, g):
    """The forward's output and the three gradients through the dispatcher's
    autograd route."""
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attention(*ts)
    out.backward(g)
    return (out.detach(), *(t.grad for t in ts))


def _pad_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key == "aten::constant_pad_nd")


def test_dit_views_and_contiguous_inputs_give_equal_bits(gen):
    """At DiT-XL/2's shape the kernels read MHSA's views where they lie:
    the same bits as contiguous copies, forward and backward, and the
    output written token-major (so MHSA's merge is a view)."""
    views = _mhsa_views(32, 16, 256, 72, gen)
    dense = [t.contiguous() for t in views]
    got, want = _fwd_bwd(*views), _fwd_bwd(*dense)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].transpose(1, 2).is_contiguous()
    assert want[0].is_contiguous()
    o, lse = FA._attention_kernel(*views[:3], with_lse=True)
    o2, lse2 = FA._attention_kernel(*dense[:3], with_lse=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(
        attention_bwd(*views[:3], o, lse, views[3]),
        attention_bwd(*dense[:3], o2, lse2, dense[3])))


def test_no_pad_on_the_bf16_route_at_width_72(gen):
    views = _mhsa_views(4, 16, 256, 72, gen)
    for ts in (views, [t.contiguous() for t in views]):
        fwd, bwd = attention.launches, attention_bwd.launches
        assert _pad_ops(lambda: _fwd_bwd(*ts)) == 0
        assert (attention.launches, attention_bwd.launches) == (fwd + 1,
                                                                bwd + 1)


@pytest.mark.parametrize("T,D", [(77, 40), (100, 72), (130, 160)])
def test_ragged_widths_take_the_true_width_route(gen, T, D):
    """The widths of the ragged shapes that are not a multiple of 64 run
    unpadded (a narrow last chunk), on views as on contiguous inputs."""
    views = _mhsa_views(4, 2, T, D, gen)
    dense = [t.contiguous() for t in views]
    plan = FA._bf16_plan(*views)
    assert (plan.width, plan.pad, plan.token_major) == (D, False, True)
    assert _pad_ops(lambda: _fwd_bwd(*views)) == 0
    got = _fwd_bwd(*views)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, _fwd_bwd(*dense)))
    q, k, v, g = dense
    torch.testing.assert_close(got[0].float(),
                               attention_plain(q, k, v).float(),
                               atol=ATOL, rtol=RTOL)
    for a, b in zip(got[1:], attention_bwd_plain(q, k, v, g)):
        assert _rel_l2(a, b) < BWD_REL_L2


# the float32 forward at head widths above 256 (route xwide): the VAE's
# width 512, one padded and one unpadded narrower width, T below a key
# tile, ragged, the VAE's T = 1024 and SD's VAE's 4096 (512 px); fp32 in
# another order: 1e-5
XWIDE_SHAPES = [(16, 512), (100, 512), (1024, 512), (100, 320), (65, 300),
                (4096, 512)]


@pytest.mark.parametrize("T,D", XWIDE_SHAPES)
def test_attention_xwide_forward_matches_plain(gen, T, D):
    q, k, v = (torch.randn(2, 1, T, D, generator=gen, device="cuda")
               for _ in range(3))
    assert FA._f32_plan(2, 1, T, D).route == "xwide"
    before = attention.launches_f32
    got = attention(q, k, v)
    again = attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches_f32 == before + 2
    assert torch.equal(got, again)
    want = attention_plain(q, k, v)
    rel = ((got - want).double().norm() / want.double().norm()).item()
    assert rel <= 1e-5, rel
    # the refusal that remains (ROADMAP.md): a width above 512 raises, it
    # does not fall back to a plain version
    wide = torch.zeros(2, 1, T, 576, device="cuda")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        attention(wide, wide, wide)


# the xwide kernels' entry points: the bf16 forward, and the backward in
# both dtypes, at the padded widths 320-512, ragged T, a T every tile
# divides, the mid site's T = 16 and the VAE's T = 1024 at width 512 (width
# 300 is zero-padded to 320)
XWIDE_BWD_SHAPES = [(100, 320), (256, 384), (16, 448), (256, 512),
                    (100, 512), (65, 300), (1024, 512), (77, 320)]


def _xwide_calls(q, k, v, g):
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
    return (o, lse, *attention_bwd(q, k, v, o, lse, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D", XWIDE_BWD_SHAPES)
def test_attention_xwide_pair_matches_plain(gen, T, D, dtype):
    q, k, v, g = (torch.randn(2, 1, T, D, generator=gen, device="cuda",
                              dtype=dtype) for _ in range(4))
    counter = "launches_f32" if dtype == torch.float32 else "launches_xwide"
    before = (getattr(attention, counter), getattr(attention_bwd, counter))
    got = _xwide_calls(q, k, v, g)
    again = _xwide_calls(q, k, v, g)
    torch.cuda.synchronize()
    assert (getattr(attention, counter), getattr(attention_bwd, counter)) \
        == (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    o, lse, *grads = got
    want = attention_plain(q, k, v)
    if dtype == torch.float32:
        # fp32 in another order: the forward 1e-5, the backward 1e-4
        assert _rel_l2(o, want) <= 1e-5
        tol = 1e-4
    else:
        torch.testing.assert_close(o.float(), want.float(), atol=ATOL,
                                   rtol=RTOL)
        tol = BWD_REL_L2
    for a, b in zip(grads, attention_bwd_plain(q, k, v, g)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel_l2(a, b) < tol


def test_attention_xwide_bf16_forward_repeats_its_bits_at_the_condunet_site(
        gen):
    # the CondUNet at model.ch 256: one head of 512 at 16 x 16; three runs
    # of the bf16 xwide forward with its log-sum-exp give the same bits,
    # one launch each, within the plain version's tolerance
    q, k, v = (torch.randn(8, 1, 256, 512, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    before = attention.launches_xwide
    runs = [FA._attention_kernel(q, k, v, with_lse=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert attention.launches_xwide == before + 3
    o, lse = runs[0]
    for other in runs[1:]:
        assert torch.equal(o, other[0]) and torch.equal(lse, other[1])
    torch.testing.assert_close(o.float(), attention_plain(q, k, v).float(),
                               atol=ATOL, rtol=RTOL)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 512 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(8, 256),
                               atol=1e-4, rtol=0)


def test_attention_xwide_bf16_gradients_through_the_dispatcher(gen):
    # the CondUNet at model.ch 256: one head of 512 at 16 x 16, training
    # batch; autograd takes the bf16 xwide pair, nothing else
    q, k, v = (torch.randn(8, 1, 256, 512, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    g = torch.randn(8, 1, 256, 512, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    before = (attention.launches, attention_bwd.launches,
              attention.launches_xwide, attention_bwd.launches_xwide)
    attention(q, k, v).backward(g)
    torch.cuda.synchronize()
    assert (attention.launches, attention_bwd.launches,
            attention.launches_xwide, attention_bwd.launches_xwide) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    for t, w in zip((q, k, v), attention_bwd_plain(q.detach(), k.detach(),
                                                   v.detach(), g)):
        assert _rel_l2(t.grad, w) < BWD_REL_L2


def test_attention_xwide_forward_takes_more_heads_than_a_grid_row(gen):
    # B * H = 65538 heads, above the 65535 of grid dimension y that holds
    # them: the launcher splits the heads over two launches, one call
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.randn(2, 32769, 16, 320, generator=gen, device="cuda")
               for _ in range(3))
    assert FA._f32_plan(2, 32769, 16, 320).route == "xwide"
    before = attention.launches_f32
    got, lse = FA._attention_kernel(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert attention.launches_f32 == before + 1
    want = attention_plain(q, k, v)
    rel = ((got - want).double().norm() / want.double().norm()).item()
    assert rel <= 1e-5, rel
    tail = slice(65530, None)          # the heads of the second launch
    got_t, want_t = (t.reshape(-1, 16, 320)[tail] for t in (got, want))
    rel = ((got_t - want_t).double().norm() / want_t.double().norm()).item()
    assert rel <= 1e-5, rel
    s = torch.matmul(q, k.transpose(-1, -2)).reshape(-1, 16, 16) * 320 ** -0.5
    torch.testing.assert_close(lse[tail], torch.logsumexp(s[tail], -1),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_xwide_backward_takes_more_heads_than_a_grid_row(gen,
                                                                  dtype):
    # B * H = 65538 heads: the key pass and the dq pass of the second
    # launch take the heads past 65535 and their rows of the dS scratch
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = (torch.randn(2, 32769, 16, 320, generator=gen, device="cuda",
                              dtype=dtype) for _ in range(4))
    o, lse = FA._attention_kernel(q, k, v, with_lse=True)
    before = (attention_bwd.launches_f32, attention_bwd.launches_xwide)
    got = attention_bwd(q, k, v, o, lse, g)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert (attention_bwd.launches_f32, attention_bwd.launches_xwide) == (
        before[0] + f32, before[1] + (not f32))
    tol = 1e-4 if f32 else BWD_REL_L2
    tail = slice(65530, None)          # the heads of the second launch
    for a, b in zip(got, attention_bwd_plain(q, k, v, g)):
        assert _rel_l2(a, b) < tol
        assert _rel_l2(a.reshape(-1, 16, 320)[tail],
                       b.reshape(-1, 16, 320)[tail]) < tol


def test_vae_on_the_card_matches_the_cpu_and_counts_its_launches(gen):
    # the full VAE at 64 px: its mid attention is one head of width 512 at
    # T = 64 (xwide); 22 GroupNorm forwards an encode and 30 a decode
    import copy

    from uurg_torch.models.autoencoder_kl import init_vae

    torch.backends.cudnn.allow_tf32 = False
    vae = init_vae(0, device="cuda")
    cpu = copy.deepcopy(vae).to("cpu")
    x = torch.rand(2, 64, 64, 3, generator=gen, device="cuda") * 2 - 1
    noise = torch.randn(2, 8, 8, 4, generator=gen, device="cuda")
    counts = []

    def counted(call):
        before = (attention.launches_f32, group_norm.launches)
        out = call()
        torch.cuda.synchronize()
        counts.append((attention.launches_f32 - before[0],
                       group_norm.launches - before[1]))
        return out

    with torch.inference_mode():
        z = counted(lambda: vae.encode(x, noise=noise))
        img = counted(lambda: vae.decode(z))
        z_cpu = cpu.encode(x.cpu(), noise=noise.cpu())
        img_cpu = cpu.decode(z_cpu)
    assert counts == [(1, 22), (1, 30)]
    for got, want in ((z, z_cpu), (img, img_cpu)):
        rel = ((got.cpu() - want).double().norm()
               / want.double().norm()).item()
        assert rel <= 1e-4, rel


# Stable Diffusion's UNet (LDM v1, 64 x 64 latents): its self-attention
# sites (T, D) at 8 heads, q, k and v the (B, H, T, D) views of three
# (B, T, H D) projections, as CrossAttention hands them over
SD_ATTN = [(4096, 40), (1024, 80), (256, 160)]


def _sd_views(B, H, T, D, gen):
    q, k, v, g = (torch.randn(B, T, H * D, generator=gen, device="cuda",
                              dtype=torch.bfloat16)
                  .reshape(B, T, H, D).transpose(1, 2) for _ in range(4))
    return q, k, v, g


@pytest.mark.parametrize("T,D", SD_ATTN)
def test_attention_kernels_at_the_sd_shapes(gen, T, D):
    """Forward (with its log-sum-exp) and backward at batch 4 x 8 heads on
    CrossAttention's views against the plain versions, the same bits on
    contiguous copies, three runs with equal bits."""
    views = _sd_views(4, 8, T, D, gen)
    q, k, v, g = views

    def run(q, k, v, g):
        o, lse = FA._attention_kernel(q, k, v, with_lse=True)
        return (o, lse, *attention_bwd(q, k, v, o, lse, g))

    first = run(*views)
    torch.cuda.synchronize()
    o, lse = first[:2]
    torch.testing.assert_close(o.float(), attention_plain(q, k, v).float(),
                               atol=ATOL, rtol=RTOL)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * D ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(-1, T),
                               atol=1e-4, rtol=1e-4)
    for name, a, b in zip("qkv", first[2:], attention_bwd_plain(q, k, v, g)):
        assert _rel_l2(a, b) < BWD_REL_L2, name
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(run(*views), first))
    contiguous = run(*(t.contiguous() for t in views))
    assert all(torch.equal(a, b) for a, b in zip(contiguous, first))


# the largest of SD's bf16 GroupNorm sites at batch 4 (by bytes a sample,
# and by channels): the split route, forward and backward
SD_GN_SWEEP = [(4, 64, 64, 960), (4, 32, 32, 2560)]


@pytest.mark.parametrize("B,H,W,C", SD_GN_SWEEP)
def test_group_norm_kernels_at_the_largest_sd_sites(gen, B, H, W, C):
    x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
         + 0.5).to(torch.bfloat16)
    g = torch.randn(B, H, W, C, generator=gen, device="cuda").to(torch.bfloat16)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    bias = torch.randn(C, generator=gen, device="cuda") * 0.2
    assert GN._fwd_route(H * W, C, 2, 32, B)[0] == "split"
    assert GN._bwd_route(H * W, C, 2, 32, B)[0] == "split"
    y, mean, rstd = group_norm(x, scale, bias, return_stats=True)
    want = group_norm_plain(x, scale, bias, 32, 1e-6, True)
    torch.testing.assert_close(y.float(), want[0].float(), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(mean, want[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, want[2], atol=1e-4, rtol=1e-4)
    got = group_norm_bwd(x, scale, mean, rstd, g)
    dx, dscale, dbias = group_norm_bwd_plain(x, scale, mean, rstd, g)
    torch.testing.assert_close(got[0].float(), dx.float(), atol=ATOL,
                               rtol=RTOL)
    assert _rel_l2(got[1], dscale) < 1e-4 and _rel_l2(got[2], dbias) < 1e-4
    for _ in range(2):
        again = group_norm_bwd(x, scale, mean, rstd, g)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


# (H, W, C) of SD's GroupNorm backward sites that no cluster holds: the
# split route (chip_smoke.SD_BWD_SPLIT_SITES); fp32 where C fits the kernel
# (C / 4 <= 512 chunks)
SD_BWD_SPLIT = [(64, 64, 320), (32, 32, 640), (64, 64, 640), (32, 32, 960),
                (64, 64, 960), (32, 32, 1280), (16, 16, 1920), (32, 32, 1920),
                (16, 16, 2560)]
SD_BWD_CASES = [(B, H, W, C, dtype) for B in (1, 4) for H, W, C in SD_BWD_SPLIT
                for dtype in (torch.bfloat16, torch.float32)
                if dtype == torch.bfloat16 or C <= 2048]


@pytest.mark.parametrize("B,H,W,C,dtype", SD_BWD_CASES)
def test_group_norm_bwd_split_at_sd_sites(gen, B, H, W, C, dtype):
    x = (torch.randn(B, H, W, C, generator=gen, device="cuda") * 2
         + 0.5).to(dtype)
    g = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(C, generator=gen, device="cuda") * 0.2 + 1.0
    _, mean, rstd = group_norm_plain(x, scale, scale, 32, 1e-6, True)
    assert GN._bwd_route(H * W, C, x.element_size(), 32, B)[0] == "split"
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, scale, mean, rstd, g)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 1           # one count a call
    dx, dscale, dbias = group_norm_bwd_plain(x, scale, mean, rstd, g)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == torch.bfloat16 else \
        dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[0].float(), dx.float(), **tol)
    # fp32 sums over batch and space of the same products in another order
    assert _rel_l2(got[1], dscale) < 1e-4 and _rel_l2(got[2], dbias) < 1e-4
    for _ in range(2):           # no float atomics: same bits every run
        again = group_norm_bwd(x, scale, mean, rstd, g)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert int(GN._fold_counters[x.device].abs().sum()) == 0   # left zero


def test_group_norm_bwd_split_in_a_cuda_graph(gen):
    """Two backward calls at an SD split site captured in one CUDA graph:
    each call has its own scratch, so the replay gives the eager bits."""
    x, g, g2 = ((torch.randn(4, 32, 32, 640, generator=gen, device="cuda")
                 + 0.5).to(torch.bfloat16) for _ in range(3))
    scale = torch.randn(640, generator=gen, device="cuda") * 0.2 + 1.0
    _, mean, rstd = group_norm_plain(x, scale, scale, 32, 1e-6, True)
    eager = [group_norm_bwd(x, scale, mean, rstd, t) for t in (g, g2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = [group_norm_bwd(x, scale, mean, rstd, t) for t in (g, g2)]
    graph.replay()
    torch.cuda.synchronize()
    for e, c in zip(eager, captured):
        assert all(torch.equal(a, b) for a, b in zip(e, c))
    assert not torch.equal(eager[0][0], eager[1][0])


def test_sd_unet_forward_matches_its_plain_path(gen):
    """The full-width SD UNet (seeded init, bf16) at batch 1 on 64 x 64
    latents and a 77 x 768 context: 15 attention and 61 GroupNorm launches
    a forward, the output within 2e-2 of the same model on its plain
    path."""
    from uurg_torch.models import layers
    from uurg_torch.models import sd_unet as TU

    model = TU.init_sd_unet(0, device="cuda")
    x = torch.randn(1, 64, 64, 4, generator=gen, device="cuda")
    t = torch.tensor([500], device="cuda")
    ctx = torch.randn(1, 77, 768, generator=gen, device="cuda")
    fwd, gn = attention.launches, group_norm.launches
    with torch.inference_mode():
        got = model(x, t, ctx)
        torch.cuda.synchronize()
        assert (attention.launches - fwd, group_norm.launches - gn) == (15, 61)
        kernels = TU.attention, layers.group_norm
        TU.attention = attention_plain
        layers.group_norm = (lambda x, s, b, *, groups, eps:
                             group_norm_plain(x, s, b, groups, eps))
        try:
            want = model(x, t, ctx)
        finally:
            TU.attention, layers.group_norm = kernels
    assert got.shape == (1, 64, 64, 4) and got.dtype == torch.float32
    assert _rel_l2(got, want) < 2e-2


def test_nsfw_removal_sgd_step_on_the_card_matches_the_cpu(gen,
                                                            monkeypatch):
    """One SFR-on step of ``nsfw_removal`` (SGD, the mask packed) on a small
    float32 SD UNet (16 x 16 latents: the float32 attention kernels at T =
    256 and 64, GroupNorm on every site) on the card against the same step
    on the CPU, t and noise injected alike: the update within 1e-3 of its
    norm (TF32 off; the sums run in other orders)."""
    import copy

    from uurg_torch.core.device import resolve_device
    from uurg_torch.models.sd_unet import SDUNetConfig, init_sd_unet
    from uurg_torch.train import optim as TO
    from uurg_torch.workloads import sd_runner as TR
    from uurg_torch.workloads.sd import SDWorkload

    monkeypatch.setattr(TR, "make_optimizer",
                        lambda name, params, lr, **kw: TO.make_optimizer(
                            "sgd", params, lr, momentum=0.9))
    resolve_device("cuda")                          # TF32 off
    cfg = SDUNetConfig(model_channels=64, channel_mult=(1, 2),
                       num_res_blocks=1, attention_ds=(1, 2), num_heads=2,
                       context_dim=32, dtype=torch.float32, remat=True)
    cpu = torch.Generator().manual_seed(1)
    z, z_r = (torch.randn(2, 16, 16, 4, generator=cpu) for _ in range(2))
    ctx = [torch.randn(2, 8, 32, generator=cpu) for _ in range(3)]
    draws = [(torch.randint(0, 1000, (2,), generator=cpu),
              torch.randn(2, 16, 16, 4, generator=cpu)) for _ in range(2)]
    start = init_sd_unet(3, cfg)
    mask = {n: torch.rand(p.shape, generator=cpu) < 0.5
            for n, p in start.named_parameters()}
    out = {}
    for dev in ("cpu", "cuda"):
        wl = SDWorkload.build(cfg, device=dev)
        queue = [(t.to(dev), n.to(dev)) for t, n in draws]
        monkeypatch.setattr(wl, "draw", lambda z, g, q=queue: q.pop(0))
        model = copy.deepcopy(start).to(dev)
        before = (attention.launches_f32, group_norm.launches)
        TR.nsfw_removal(wl, model, iter([(z, ctx[0], ctx[1])]),
                        iter([(z_r, ctx[2])]), n_iters=1, lr=1e-2,
                        saliency_mask=mask, pack_mask=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert attention.launches_f32 > before[0]
            assert group_norm.launches > before[1]
        out[dev] = torch.cat([(p.detach().cpu() - q.detach()).reshape(-1)
                              for p, q in
                              zip(model.parameters(), start.parameters())])
    assert out["cpu"].norm() > 0
    assert _rel_l2(out["cuda"], out["cpu"]) < 1e-3


def test_prox_threshold_at_full_width(gen):
    """``make_prox_operator`` on the full-width SD UNet (859,520,964
    parameters): the threshold it applies is ``sort(|delta|)[-k]`` at
    k = 1% of the parameters, the moves under it zeroed."""
    from uurg_torch.models.sd_unet import init_sd_unet
    from uurg_torch.workloads.sd import SDWorkload

    wl = SDWorkload.build(device="cuda")
    init = init_sd_unet(0, device="cuda")
    model = init_sd_unet(0, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3)
        flat = torch.cat([(p - a).abs().reshape(-1) for p, a in
                          zip(model.parameters(), init.parameters())])
        k = max(1, int(flat.numel() * 0.01))
        want = torch.sort(flat).values[-k].item()
        del flat
    prox = wl.make_prox_operator(init, 0.01)
    assert prox(model).item() == want
    with torch.no_grad():
        moved = sum(int(((p - a) != 0).sum()) for p, a in
                    zip(model.parameters(), init.parameters()))
    assert 0 < moved <= k
