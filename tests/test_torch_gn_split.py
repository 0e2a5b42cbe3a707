"""The GroupNorm forward's split route on the CPU: which shapes take it and
with how many runs a sample, the scratch its wrapper allocates, and a
float32 numpy emulation of its fold order held against the JAX reference
(``uurg_tpu/ops/group_norm.py::_gn_reference``). The kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.ops import group_norm as GN  # noqa: E402
from uurg_tpu.ops.group_norm import _gn_reference  # noqa: E402

SMS = GN._SMS   # the split count aims at blocks a launch of them
# threads a block of the split route: kSplitThreads of csrc/group_norm.cu
SPLIT_THREADS = 256

# (H, W, C) of the VAE's eight fp32 GroupNorm sites at 256 px (encoder and
# decoder of VAEConfig(): 256 x 256 at 128 and 256 channels, 128 x 128 at
# 128, 256 and 512, 64 x 64 at 256 and 512, 32 x 32 at 512), at its batch 32
VAE_SITES = [(256, 256, 128), (256, 256, 256), (128, 128, 128),
             (128, 128, 256), (128, 128, 512), (64, 64, 256), (64, 64, 512),
             (32, 32, 512)]
# SD's bf16 UNet sites that fit no cluster, at the batches of its CLIs
SD_SITES = [(64, 64, 320), (64, 64, 640), (64, 64, 960), (32, 32, 1280),
            (32, 32, 1920), (32, 32, 2560)]
# the CondUNet's sites in bf16 (H = W, C, cluster): the slab route at any
# batch
SLAB_SITES = [(32, 128, 2), (16, 256, 1), (32, 256, 4), (32, 384, 4),
              (16, 512, 2), (4, 512, 1)]


@pytest.mark.parametrize("H,W,C", VAE_SITES)
def test_vae_sites_take_the_split_route_filling_the_card(H, W, C):
    route = GN._fwd_route(H * W, C, 4, 32, 32)
    # the card at any batch: at least two blocks an SM (here 17 runs a
    # sample, 544 blocks)
    assert route == ("split", 17)
    assert 32 * route[1] >= 2 * SMS
    # a run holds whole pixels, at least _SPLIT_MIN_BYTES of them
    assert route[1] <= H * W
    assert H * W * C * 4 // route[1] >= GN._SPLIT_MIN_BYTES
    # no cluster holds the sample: the slab route would not fit
    assert GN._slab_cluster(GN._slab_smem, H * W, C, 4, 32) is None


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("H,W,C", SD_SITES)
def test_sd_sites_take_the_split_route_at_small_batches(H, W, C, batch):
    route = GN._fwd_route(H * W, C, 2, 32, batch)
    assert route[0] == "split"
    assert batch * route[1] >= 2 * SMS           # two blocks an SM or more
    assert route[1] == GN._split_count(batch, H * W, C, 2)
    assert route[1] <= GN._SPLIT_MAX


@pytest.mark.parametrize("batch", [1, 4, 32, 256])
@pytest.mark.parametrize("H,C,S", SLAB_SITES)
def test_slab_sites_keep_their_cluster_at_every_batch(H, C, S, batch):
    assert GN._fwd_route(H * H, C, 2, 32, batch) == ("slab", S)


@pytest.mark.parametrize("batch,hw,c,itemsize,want", [
    (32, 1024, 512, 4, 17),     # ceil(528 / 32)
    (4, 4096, 320, 2, 132),     # 528 / 4
    (1, 4096, 320, 2, 264),     # at most two an SM's worth a sample
    (1, 1024, 2560, 2, 264),
    (1, 1, 64, 2, 1),           # one pixel: one run
    (32, 1, 512, 4, 1),
    (2, 3, 4096, 2, 3),         # at most a run a pixel
    (2, 64, 32, 4, 1),          # 8 KB: one run of _SPLIT_MIN_BYTES
    (1000, 4096, 512, 4, 1),    # a large batch fills the card alone
])
def test_split_count_rule(batch, hw, c, itemsize, want):
    got = GN._split_count(batch, hw, c, itemsize)
    assert got == want
    # a pure function of the shape: the cached route gives the same count
    # whatever was asked before
    assert GN._split_count(batch, hw, c, itemsize) == got
    assert 1 <= got <= min(GN._SPLIT_MAX, hw)
    assert got == 1 or hw * c * itemsize // got >= GN._SPLIT_MIN_BYTES
    # capped by the sample, or enough blocks in all
    assert got == max(1, min(GN._SPLIT_MAX, hw,
                             hw * c * itemsize // GN._SPLIT_MIN_BYTES)) or \
        batch * got >= GN._SPLIT_BLOCKS


@pytest.fixture
def fake_launch(monkeypatch):
    """The forward launcher replaced by a recorder (no card here), and a
    stream that the CPU can name: what the wrapper hands the kernel."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(GN, "_load", lambda *a: launch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


@pytest.mark.parametrize("shape,dtype,route", [
    ((4, 64, 64, 320), torch.bfloat16, ("split", 132)),
    ((32, 32, 32, 512), torch.float32, ("split", 17)),
    ((3, 1, 1, 64), torch.bfloat16, ("split", 1)),
    ((2, 32, 32, 256), torch.bfloat16, ("slab", 4)),
])
def test_wrapper_allocates_the_split_scratch_per_call(fake_launch, shape,
                                                      dtype, route):
    b, h, w, c = shape
    x = torch.zeros(shape, dtype=dtype)
    scale, bias = torch.ones(c), torch.zeros(c)
    assert GN._fwd_route(h * w, c, x.element_size(), 32, b) == route
    before = GN.group_norm.launches
    y, mean, rstd = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
    y2, mean2, _ = GN._group_norm_kernel(x, scale, bias, 32, 1e-6)
    assert GN.group_norm.launches == before + 2        # calls, not kernels
    args = fake_launch[0]
    # x, scale, bias, y, mean, rstd, part, B, HW, C, G, eps, dtype, route, S
    assert args[7:11] == (b, h * w, c, 32)
    assert args[12:15] == (GN._DTYPE_CODE[dtype], GN._ROUTE_CODE[route[0]],
                           route[1])
    stats = 2 * b * 32
    part = GN._split_scratch(b, route[1], 32) if route[0] == "split" else 0
    assert part == (b * route[1] * 2 * 32 if route[0] == "split" else 0)
    # mean, rstd and the partial sums are one fp32 allocation of the call
    assert mean.untyped_storage().nbytes() == 4 * (stats + part)
    assert (args[4], args[5], args[6]) == (
        mean.data_ptr(), mean.data_ptr() + 4 * b * 32,
        mean.data_ptr() + 4 * stats)
    assert rstd.data_ptr() == args[5] and mean.shape == rstd.shape == (b, 32)
    assert mean.is_contiguous() and rstd.is_contiguous()
    # a second call has its own scratch (calls captured in one CUDA graph
    # share none)
    assert mean2.data_ptr() != mean.data_ptr() and y2.data_ptr() != \
        y.data_ptr()


def _fma(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding
    (as the kernel's q += v * v compiles)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_split(x, scale, bias, groups, eps, S, itemsize):
    """The split route's arithmetic in float32 numpy, in the kernel's order:
    a thread (pixel row r0 of `rows`, one channel here) sums its run's
    pixels r0, r0 + rows, ... in order; the block adds its rows per channel
    in order and its channels per group in order (fold_partials); the
    normalise launch adds the S run rows of a sample as four interleaved
    chains in index order, (a0 + a1) + (a2 + a3) (fold_runs); then
    group_stats and y = x a + b. Returns (y, mean, rstd) and the runs."""
    B, H, W, C = x.shape
    hw, cg = H * W, C // groups
    xs = x.reshape(B, hw, C).astype(np.float32)
    rows = max(1, SPLIT_THREADS // (C * itemsize // 16))
    part = np.zeros((B, S, 2, groups), np.float32)
    size, longer = divmod(hw, S)     # the first hw % S runs are longer
    runs = [(j * size + min(j, longer), (j + 1) * size + min(j + 1, longer))
            for j in range(S)]
    for b in range(B):
        for j, (p0, p1) in enumerate(runs):
            s = np.zeros((rows, C), np.float32)
            q = np.zeros((rows, C), np.float32)
            for k in range(0, p1 - p0, rows):
                for r0 in range(rows):
                    if p0 + k + r0 < p1:
                        v = xs[b, p0 + k + r0]
                        s[r0] = s[r0] + v
                        q[r0] = _fma(v, v, q[r0])
            ch = np.zeros((2, C), np.float32)
            for r0 in range(rows):
                ch[0] = ch[0] + s[r0]
                ch[1] = ch[1] + q[r0]
            grp = np.zeros((2, groups), np.float32)
            for k in range(cg):
                grp = grp + ch[:, k::cg]
            part[b, j] = grp
    lanes = []
    for u in range(4):
        acc = np.zeros((B, 2, groups), np.float32)
        for r in range(u, S, 4):
            acc = acc + part[:, r]
        lanes.append(acc)
    tot = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    n = np.float32(hw) * np.float32(cg)
    mean = tot[:, 0] / n
    var = np.maximum(tot[:, 1] / n - mean * mean, np.float32(0))
    rstd = (1 / np.sqrt(var + np.float32(eps))).astype(np.float32)
    a = np.repeat(rstd, cg, axis=1) * scale                   # (B, C)
    bt = bias - np.repeat(mean, cg, axis=1) * a
    y = xs * a[:, None] + bt[:, None]
    return y.reshape(x.shape), mean, rstd, runs


# fp32 on both sides, the sums in another order: the tolerance of
# tests/test_torch_ops.py's GroupNorm parity (2e-5)
GN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,itemsize,S", [
    ((2, 5, 5, 256), 4, 3),      # runs of 9, 8 and 8 pixels
    ((3, 12, 12, 384), 4, 5),    # groups of 12 channels, uneven lanes
    ((1, 1, 1, 64), 2, 1),       # one pixel
    ((2, 16, 16, 128), 2, 13),   # bf16 rows of 16 threads, 13 runs
    ((1, 32, 32, 512), 4, None), # the wrapper's own count: 256 runs
])
def test_split_fold_order_matches_jax_reference(shape, itemsize, S):
    B, H, W, C = shape
    if S is None:
        S = GN._fwd_route(H * W, C, itemsize, 32, B)[1]
        assert S == 256
    rng = np.random.default_rng(C * 100 + H)
    x = (rng.standard_normal(shape, dtype=np.float32) * 2 + 0.3)
    if itemsize == 2:       # the values a bf16 tensor holds, exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    scale = rng.standard_normal(C, dtype=np.float32) * 0.1 + 1.0
    bias = rng.standard_normal(C, dtype=np.float32) * 0.1
    y, mean, rstd, runs = _emulate_split(x, scale, bias, 32, 1e-6, S,
                                         itemsize)
    # the runs cover each pixel once, whole pixels, none empty
    assert runs[0][0] == 0 and runs[-1][1] == H * W
    assert all(a < b == c for (a, b), (c, _) in zip(runs, runs[1:] + [(
        H * W, 0)]))
    ref = np.asarray(_gn_reference(jnp.asarray(x), jnp.asarray(scale),
                                   jnp.asarray(bias), 32, 1e-6))
    np.testing.assert_allclose(y, ref, **GN_TOL)
    xr = x.reshape(B, -1, 32, C // 32).astype(np.float64)
    np.testing.assert_allclose(mean, xr.mean(axis=(1, 3)), **GN_TOL)
    var = xr.var(axis=(1, 3))
    np.testing.assert_allclose(rstd, 1 / np.sqrt(var + 1e-6), rtol=1e-4)
    # and the port's plain version, which the card's checks hold it to
    want, mean_p, rstd_p = GN.group_norm_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        32, 1e-6, True)
    np.testing.assert_allclose(y, want.numpy(), **GN_TOL)
    np.testing.assert_allclose(mean, mean_p.numpy(), **GN_TOL)
    np.testing.assert_allclose(rstd, rstd_p.numpy(), rtol=1e-4)
