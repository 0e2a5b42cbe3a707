"""The GroupNorm backward's split route on the CPU: which shapes take it and
with how many runs a sample, the scratch its wrapper allocates, and a
float32 numpy emulation of its fold order (runs, groups, channel rows, the
batch fold) held against the JAX package's ``fused_group_norm`` backward
in interpret mode (``uurg_tpu/ops/group_norm.py::_bwd``, through
``jax.vjp``). The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.ops import group_norm as GN  # noqa: E402
from uurg_tpu.ops.group_norm import _fwd_impl, fused_group_norm  # noqa: E402

SMS = GN._SMS
# threads a block of the split route: kSplitThreads of csrc/group_norm.cu
SPLIT_THREADS = 256

# (H, W, C, sites a backward) of SD's bf16 UNet GroupNorm sites that eight
# slices of x and g do not fit: 33 of the 61 sites a backward
SD_BWD_SITES = [(64, 64, 320, 13), (32, 32, 640, 11), (64, 64, 640, 2),
                (32, 32, 960, 1), (64, 64, 960, 1), (32, 32, 1280, 1),
                (16, 16, 1920, 1), (32, 32, 1920, 1), (16, 16, 2560, 2)]
# the CondUNet's eleven bf16 sites (H = W, C, cluster): the slab route
BWD_SLAB_SITES = [(32, 128, 4), (16, 256, 2), (32, 256, 8), (4, 256, 1),
                  (32, 384, 8), (16, 512, 4), (8, 256, 1), (16, 384, 2),
                  (4, 512, 1), (8, 512, 1), (16, 128, 1)]


def test_sd_sites_are_a_third_of_a_unet_backward():
    assert sum(n for *_, n in SD_BWD_SITES) == 33


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("H,W,C,sites", SD_BWD_SITES)
def test_sd_sites_take_the_split_route_filling_the_card(H, W, C, sites,
                                                        batch):
    hw = H * W
    route = GN._bwd_route(hw, C, 2, 32, batch)
    assert route == ("split", GN._bwd_split_count(batch, hw, C, 2))
    S = route[1]
    # a run is whole pixels, at least _BWD_MIN_PIXELS of them
    assert 1 <= S <= hw // GN._BWD_MIN_PIXELS
    # the card fills: at least a block an SM, or every run at its shortest
    assert batch * S >= SMS or S == hw // GN._BWD_MIN_PIXELS
    # two blocks an SM in all where the runs are long enough
    assert S == min(-(-2 * SMS // batch), hw // GN._BWD_MIN_PIXELS)
    # no cluster holds x and g of a sample
    assert GN._slab_cluster(GN._bwd_slab_smem, hw, C, 2, 32) is None


@pytest.mark.parametrize("batch", [1, 4, 32, 128, 256])
@pytest.mark.parametrize("H,C,S", BWD_SLAB_SITES)
def test_slab_sites_keep_their_cluster_at_every_batch(H, C, S, batch):
    assert GN._bwd_route(H * H, C, 2, 32, batch) == ("slab", S)


@pytest.mark.parametrize("batch,hw,c,itemsize,want", [
    (4, 4096, 320, 2, 66),      # 264 / 4 runs of 62 or 63 pixels
    (1, 4096, 320, 2, 256),     # at most a run a _BWD_MIN_PIXELS pixels
    (4, 1024, 640, 2, 64),
    (4, 256, 2560, 2, 16),
    (1, 1, 64, 2, 1),           # one pixel: one run
    (3, 1024, 384, 4, 64),
    (40, 64, 128, 4, 4),
    (1000, 4096, 512, 4, 1),    # a large batch fills the card alone
])
def test_bwd_split_count_rule(batch, hw, c, itemsize, want):
    got = GN._bwd_split_count(batch, hw, c, itemsize)
    assert got == want
    assert got == max(1, min(-(-GN._BWD_SPLIT_BLOCKS // batch),
                             hw // GN._BWD_MIN_PIXELS,
                             hw * c * itemsize // GN._SPLIT_MIN_BYTES))


@pytest.fixture
def fake_launch(monkeypatch):
    """The backward launcher replaced by a recorder (no card here), the
    fold counters kept apart, and a stream the CPU can name."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(GN, "_load", lambda *a: launch)
    monkeypatch.setattr(GN, "_fold_counters", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


@pytest.mark.parametrize("shape,dtype,route", [
    ((4, 64, 64, 320), torch.bfloat16, ("split", 66)),
    ((4, 16, 16, 2560), torch.bfloat16, ("split", 16)),
    ((3, 32, 32, 384), torch.float32, ("split", 64)),
    ((1, 1, 1, 64), torch.bfloat16, ("split", 1)),
    ((20, 16, 16, 1024), torch.float32, ("split", 14)),  # two fold groups
    ((2, 32, 32, 256), torch.bfloat16, ("slab", 8)),
])
def test_wrapper_allocates_the_split_scratch_per_call(fake_launch, shape,
                                                      dtype, route):
    b, h, w, c = shape
    x = torch.zeros(shape, dtype=dtype)
    g = torch.zeros(shape, dtype=dtype)
    scale = torch.ones(c)
    mean, rstd = torch.zeros(b, 32), torch.ones(b, 32)
    assert GN._bwd_route(h * w, c, x.element_size(), 32, b) == route
    before = GN.group_norm_bwd.launches
    dx, dscale, dbias = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g)
    dx2, dscale2, _ = GN._group_norm_bwd_kernel(x, scale, mean, rstd, g)
    assert GN.group_norm_bwd.launches == before + 2     # calls, not kernels
    args = fake_launch[0]
    # x, g, scale, mean, rstd, dx, work, counters, runs, B, HW, C, G, fold,
    # dtype, route, S, stream
    fold = GN._fold_rows(b)
    assert args[9:14] == (b, h * w, c, 32, fold)
    assert args[14:17] == (GN._DTYPE_CODE[dtype], GN._ROUTE_CODE[route[0]],
                           route[1])
    fold_floats = (2 + 2 * b + 2 * -(-b // fold)) * c
    runs = GN._bwd_split_scratch(b, route[1], c, 32) \
        if route[0] == "split" else 0
    assert runs == (b * route[1] * 2 * (c + 32) if route[0] == "split"
                    else 0)
    # dscale, dbias, the batch fold's rows and the runs' sums are one fp32
    # allocation of the call, the runs' sums 16-byte aligned after the rest
    assert dscale.untyped_storage().nbytes() == 4 * (fold_floats + runs)
    assert args[6] == dscale.data_ptr() and dbias.data_ptr() == \
        dscale.data_ptr() + 4 * c
    assert args[8] == args[6] + 4 * fold_floats and args[8] % 16 == 0
    assert args[7] == GN._fold_counters[x.device].data_ptr()
    assert dscale.shape == dbias.shape == (c,)
    # a second call has its own scratch (calls captured in one CUDA graph
    # share none); the counters stay one buffer a device
    assert dscale2.data_ptr() != dscale.data_ptr()
    assert dx2.data_ptr() != dx.data_ptr()
    assert fake_launch[1][7] == args[7]


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _fold_lanes(S):
    """fold_lanes of csrc/group_norm.cu: the fewest lanes a column with at
    most 16 (kFoldRows) of the S rows each, at most 32."""
    lanes = 1
    while lanes < 32 and lanes * 16 < S:
        lanes *= 2
    return lanes


def _fold_runs(rows):
    """fold_runs over axis 0 of ``rows`` (S, ...): lane u of a group adds
    rows u, u + lanes, ... in order, then the lanes pair up by shuffles
    (xor 1, then 2, ...): a pairwise tree over the lanes in order."""
    S = rows.shape[0]
    lanes = _fold_lanes(S)
    acc = [np.zeros(rows.shape[1:], np.float32) for _ in range(lanes)]
    for u in range(lanes):
        for r in range(u, S, lanes):
            acc[u] = acc[u] + rows[r]
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    return acc[0]


def _emulate_bwd_split(x, g, scale, mean, rstd, S, itemsize):
    """The split route's backward in float32 numpy, in the kernels' order.
    Launch 1: a thread (pixel row r0 of ``rows``, a channel here) adds its
    run's pixels r0, r0 + rows, ... in order into sum g and sum g x_hat (an
    fma); the block adds its rows per channel in order, then per group
    (fold_partials, scale-weighted by fma). Launch 2: s1 and s2 from the
    sample's S group rows (fold_runs) over the group's size; each sample's
    channel row from its S runs (fold_runs); dx; dscale and dbias from the
    sample rows in groups of _fold_rows(B) in index order, then the groups
    in order (fold_batch). Returns (dx, dscale, dbias) and the runs."""
    B, H, W, C = x.shape
    groups = mean.shape[1]
    hw, cg = H * W, C // groups
    xs = x.reshape(B, hw, C).astype(np.float32)
    gs = g.reshape(B, hw, C).astype(np.float32)
    rows = max(1, SPLIT_THREADS // (C * itemsize // 16))
    size, longer = divmod(hw, S)
    runs = [(j * size + min(j, longer), (j + 1) * size + min(j + 1, longer))
            for j in range(S)]
    m = np.repeat(mean, cg, axis=1).astype(np.float32)        # (B, C)
    rs = np.repeat(rstd, cg, axis=1).astype(np.float32)
    xhat = ((xs - m[:, None]) * rs[:, None]).astype(np.float32)
    chs = np.zeros((B, S, 2, C), np.float32)
    grps = np.zeros((B, S, 2, groups), np.float32)
    for b in range(B):
        for j, (p0, p1) in enumerate(runs):
            sa = np.zeros((rows, C), np.float32)
            sb = np.zeros((rows, C), np.float32)
            for k in range(p0, p1, rows):
                n = min(rows, p1 - k)
                sa[:n] = sa[:n] + gs[b, k:k + n]
                sb[:n] = _fma(gs[b, k:k + n], xhat[b, k:k + n], sb[:n])
            ch = np.zeros((2, C), np.float32)
            for r0 in range(rows):
                ch[0] = ch[0] + sb[r0]
                ch[1] = ch[1] + sa[r0]
            grp = np.zeros((2, groups), np.float32)
            for k in range(cg):
                grp = _fma(ch[:, k::cg], scale[k::cg], grp)
            chs[b, j], grps[b, j] = ch, grp
    inv_n = np.float32(1) / (np.float32(hw) * np.float32(cg))
    dx = np.empty_like(xs)
    sample_rows = np.zeros((B, 2, C), np.float32)
    for b in range(B):
        grp = _fold_runs(grps[b]) * inv_n
        s2 = np.repeat(grp[0], cg)
        s1 = np.repeat(grp[1], cg)
        sample_rows[b] = _fold_runs(chs[b])
        dx[b] = (gs[b] * scale - s1 - xhat[b] * s2) * rs[b]
    fold = GN._fold_rows(B)
    if B <= fold:
        out = np.zeros((2, C), np.float32)
        for b in range(B):
            out = out + sample_rows[b]
    else:
        parts = []
        for r0 in range(0, B, fold):
            acc = np.zeros((2, C), np.float32)
            for b in range(r0, min(B, r0 + fold)):
                acc = acc + sample_rows[b]
            parts.append(acc)
        out = np.zeros((2, C), np.float32)
        for p in parts:
            out = out + p
    return dx.reshape(x.shape), out[0], out[1], runs


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# fp32 dx: the same fp32 products in another order, then gs - s1 - x_hat s2,
# which cancels where the three are close (chip_smoke.py's GN_BWD_FP32_TOL);
# dscale and dbias: fp32 sums over batch and space in another order
DX_TOL = dict(rtol=1e-4, atol=1e-4)
SUM_REL_L2 = 1e-5


@pytest.mark.parametrize("shape,groups,itemsize,S", [
    ((2, 5, 5, 256), 32, 4, 3),      # ragged runs of 9, 8 and 8 pixels
    ((3, 12, 12, 384), 32, 4, 5),    # groups of 12 channels, ragged runs
    ((1, 1, 1, 64), 32, 2, 1),       # one pixel, bf16 rows of 32 threads
    ((18, 4, 4, 64), 32, 4, 2),      # two fold groups of 16 and 2 samples
    ((2, 16, 16, 256), 32, 2, 17),   # bf16 rows of 8 threads, 2 lanes
    ((1, 64, 64, 256), 32, 2, None), # the wrapper's count: 256 runs, 16 lanes
])
def test_bwd_split_fold_order_matches_jax(shape, groups, itemsize, S):
    B, H, W, C = shape
    if S is None:
        S = GN._bwd_route(H * W, C, itemsize, groups, B)[1]
        assert S == 256 and _fold_lanes(S) == 16
    rng = np.random.default_rng(C * 100 + H + B)
    x = rng.standard_normal(shape, dtype=np.float32) * 2 + 0.3
    g = rng.standard_normal(shape, dtype=np.float32)
    if itemsize == 2:       # the values a bf16 tensor holds, exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    scale = rng.standard_normal(C, dtype=np.float32) * 0.2 + 1.0
    bias = rng.standard_normal(C, dtype=np.float32) * 0.2
    xj, sj, bj = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    # the statistics the JAX backward reads: its forward's residuals
    _, mean, rstd = _fwd_impl(xj, sj, bj, groups, 1e-6, True)
    mean, rstd = np.array(mean), np.array(rstd)
    _, vjp = jax.vjp(lambda a, s, b: fused_group_norm(a, s, b, groups, 1e-6,
                                                      True), xj, sj, bj)
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    dx, dscale, dbias, runs = _emulate_bwd_split(x, g, scale, mean, rstd, S,
                                                 itemsize)
    # the runs cover each pixel once, whole pixels, none empty
    assert runs[0][0] == 0 and runs[-1][1] == H * W
    assert all(p0 < p1 for p0, p1 in runs)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    np.testing.assert_allclose(dx, want[0], **DX_TOL)
    assert _rel_l2(dscale, want[1]) < SUM_REL_L2
    assert _rel_l2(dbias, want[2]) < SUM_REL_L2
    # and the port's plain version, which the card's checks hold it to
    plain = GN.group_norm_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(g))
    np.testing.assert_allclose(dx, plain[0].numpy(), **DX_TOL)
    assert _rel_l2(dscale, plain[1].numpy()) < SUM_REL_L2
    assert _rel_l2(dbias, plain[2].numpy()) < SUM_REL_L2
