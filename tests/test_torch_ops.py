"""uurg_torch kernels' plain versions vs the JAX ops they port (CPU, fp32),
and the dispatchers' refusal paths."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.core.device import resolve_device  # noqa: E402
from uurg_torch.ops import _build  # noqa: E402
from uurg_torch.ops.flash_attention import attention  # noqa: E402
from uurg_torch.ops import group_norm as GN  # noqa: E402
from uurg_torch.ops.group_norm import group_norm  # noqa: E402
from uurg_tpu.ops.flash_attention import (  # noqa: E402
    _reference_attention,
    fused_attention,
)
from uurg_tpu.ops.group_norm import _fwd_impl, _gn_reference  # noqa: E402

# fp32 on both sides; only the summation order differs
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
GN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T", [16, 128, 256])
@pytest.mark.parametrize("D", [64, 256])
def test_attention_matches_jax(T, D):
    rng = np.random.default_rng(T * 1000 + D)
    q, k, v = (rng.standard_normal((2, 1, T, D), dtype=np.float32)
               for _ in range(3))
    launches = attention.launches
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v)).numpy()
    assert attention.launches == launches     # CPU tensors: plain version
    ref = np.asarray(_reference_attention(q, k, v))
    pallas = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), min(256, T), True))
    np.testing.assert_allclose(got, ref, **ATTN_TOL)
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)


# T that no tile size divides and head widths that the CUDA wrapper pads to a
# multiple of 64: the dispatcher's CPU path must not depend on either
RAGGED = [(77, 40), (100, 72), (130, 160), (256, 192)]


@pytest.mark.parametrize("T,D", RAGGED)
def test_attention_matches_jax_at_ragged_shapes(T, D):
    rng = np.random.default_rng(T * 1000 + D)
    q, k, v = (rng.standard_normal((2, 2, T, D), dtype=np.float32)
               for _ in range(3))
    launches = attention.launches
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v))
    assert attention.launches == launches     # CPU tensors: plain version
    assert got.shape == (2, 2, T, D) and got.dtype == torch.float32
    ref = np.asarray(_reference_attention(q, k, v))
    # fp32 on both sides, the sums over T in another order: ATTN_TOL
    np.testing.assert_allclose(got.numpy(), ref, **ATTN_TOL)


@pytest.mark.parametrize("C", [64, 128, 384])
def test_group_norm_matches_jax(C):
    rng = np.random.default_rng(C)
    x = (rng.standard_normal((3, 8, 8, C), dtype=np.float32) * 2 + 0.3)
    scale = rng.standard_normal(C, dtype=np.float32) * 0.1 + 1.0
    bias = rng.standard_normal(C, dtype=np.float32) * 0.1
    launches = group_norm.launches
    got, mean, rstd = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), groups=32,
                                 return_stats=True)
    assert group_norm.launches == launches
    ref = np.asarray(_gn_reference(x, scale, bias, 32, 1e-6))
    y_p, mean_p, rstd_p = _fwd_impl(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), 32, 1e-6, True)
    np.testing.assert_allclose(got.numpy(), ref, **GN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_p), **GN_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_p), **GN_TOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_p), rtol=1e-4)


# H = W, C and the cluster size of every GroupNorm site of a full-width
# CondUNet forward in bf16: the smallest cluster whose block (slice and
# scratch) fits a block's shared memory
MAIN_PATH_ROUTES = [(32, 128, 2), (16, 256, 1), (32, 256, 4), (4, 256, 1),
                    (32, 384, 4), (16, 512, 2), (8, 256, 1), (16, 384, 1),
                    (4, 512, 1), (8, 512, 1), (16, 128, 1)]


@pytest.mark.parametrize("H,C,S", MAIN_PATH_ROUTES)
def test_fwd_route_main_path_shapes_take_the_slab_route(H, C, S):
    hw, pixel = H * H, C * 2
    assert GN._fwd_route(hw, C, 2) == ("slab", S)
    slice_bytes = -(-hw // S) * pixel
    assert slice_bytes % pixel == 0 and slice_bytes % 16 == 0
    assert slice_bytes < GN._slab_smem(hw, C, 2, 32, S) <= GN._SMEM_MAX
    assert S <= hw and S in GN._CLUSTERS
    # no smaller cluster would do
    assert S == 1 or GN._slab_smem(hw, C, 2, 32, S // 2) > GN._SMEM_MAX


@pytest.mark.parametrize("hw,C,itemsize,want", [
    (1024, 512, 4, ("split", 256)),  # 2 MB: 256 KB a slice of eight; at
                                     # batch 1, 256 runs of 8 KB
    (1, 64, 2, ("split", 1)),       # one pixel: nothing to hold
    (1024, 384, 4, ("slab", 8)),    # 192 KB slices
    (25, 256, 2, ("slab", 1)),
    (441, 384, 2, ("slab", 2)),     # 220 and 221 pixels
    (729, 512, 2, ("slab", 4)),     # 182, 182, 182 and 183 pixels
    (841, 640, 2, ("slab", 8)),     # 105 and 106 pixels
    (64, 24, 4, ("slab", 1)),
    (64, 12, 2, ("split", 1)),      # a pixel of 24 bytes: not whole chunks
])
def test_fwd_route_off_the_main_path(hw, C, itemsize, want):
    route = GN._fwd_route(hw, C, itemsize)
    assert route == want
    if route[0] == "slab":
        assert route[1] < hw
        assert GN._slab_smem(hw, C, itemsize, 32, route[1]) <= GN._SMEM_MAX


# the same sites for the backward, whose slab holds x and g: twice the
# bytes a sample, so the cluster doubles wherever the forward's slice was
# the limit (32x32x384 at S = 8 is the tightest block: 215 of 226 KB)
BWD_MAIN_PATH_ROUTES = [(32, 128, 4), (16, 256, 2), (32, 256, 8), (4, 256, 1),
                        (32, 384, 8), (16, 512, 4), (8, 256, 1), (16, 384, 2),
                        (4, 512, 1), (8, 512, 1), (16, 128, 1)]


@pytest.mark.parametrize("H,C,S", BWD_MAIN_PATH_ROUTES)
def test_bwd_route_main_path_shapes_take_the_slab_route(H, C, S):
    hw = H * H
    assert GN._bwd_route(hw, C, 2) == ("slab", S)
    # x and g are both held: the slab route reads each from device memory once
    slices = 2 * -(-hw // S) * C * 2
    assert slices < GN._bwd_slab_smem(hw, C, 2, 32, S) <= GN._SMEM_MAX
    assert S < hw and S in GN._CLUSTERS
    # no smaller cluster would do
    assert S == 1 or GN._bwd_slab_smem(hw, C, 2, 32, S // 2) > GN._SMEM_MAX
    # the forward's block holds x alone: never a larger cluster
    assert GN._fwd_route(hw, C, 2)[1] <= S


@pytest.mark.parametrize("hw,C,itemsize,groups,want", [
    (1024, 384, 4, 32, ("split", 64)),  # 3 MB of x and g: 384 KB a slice of
                                        # eight; at batch 1, runs of 16 pixels
    (1, 64, 2, 32, ("split", 1)),       # one pixel: nothing to hold
    (1024, 128, 4, 32, ("slab", 8)),
    (25, 128, 2, 32, ("slab", 1)),      # H = 5
    (144, 384, 2, 32, ("slab", 2)),     # H = 12: 72 pixels a slice
    (441, 384, 2, 32, ("slab", 4)),     # 110, 110, 110 and 111 pixels
    (841, 640, 2, 32, ("split", 52)),   # runs of 16 and 17 pixels
    (64, 24, 4, 8, ("slab", 1)),        # C = 24, G = 8
    (64, 12, 2, 4, ("split", 1)),       # a pixel of 24 bytes: not whole chunks
])
def test_bwd_route_off_the_main_path(hw, C, itemsize, groups, want):
    route = GN._bwd_route(hw, C, itemsize, groups)
    assert route == want
    for s in GN._CLUSTERS:                  # slab wherever a cluster fits
        fits = s < hw and C * itemsize % 16 == 0 and \
            GN._bwd_slab_smem(hw, C, itemsize, groups, s) <= GN._SMEM_MAX
        assert not fits or route[0] == "slab" and route[1] <= s


@pytest.mark.parametrize("b,fold,groups", [(1, 16, 1), (3, 16, 1), (128, 16, 8),
                                           (256, 16, 16), (1024, 16, 64),
                                           (1025, 17, 61), (10 ** 5, 1563, 64)])
def test_bwd_batch_fold_groups_fit_the_counters(b, fold, groups):
    # the group size of the backward's batch fold: 16 samples a group until
    # there would be more groups than counters
    got = GN._fold_rows(b)
    assert (got, -(-b // got)) == (fold, groups)
    assert groups <= GN._FOLD_GROUPS


@pytest.mark.parametrize("H", [5, 12])
@pytest.mark.parametrize("C", [128, 384])
def test_group_norm_matches_jax_at_ragged_slices(H, C):
    # H W not a multiple of 8 (a cluster's last slice is shorter) and, at
    # C = 384, groups of 12 channels that a 16-byte chunk straddles: the CPU
    # path must not depend on either. fp32 on both sides, the sums in
    # another order: GN_TOL, as test_group_norm_matches_jax
    rng = np.random.default_rng(H * 1000 + C)
    x = (rng.standard_normal((3, H, H, C), dtype=np.float32) * 2 + 0.3)
    scale = rng.standard_normal(C, dtype=np.float32) * 0.1 + 1.0
    bias = rng.standard_normal(C, dtype=np.float32) * 0.1
    launches = group_norm.launches
    got, mean, rstd = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), groups=32,
                                 return_stats=True)
    assert group_norm.launches == launches     # CPU tensors: plain version
    assert mean.shape == rstd.shape == (3, 32)
    ref = np.asarray(_gn_reference(x, scale, bias, 32, 1e-6))
    np.testing.assert_allclose(got.numpy(), ref, **GN_TOL)
    xr = x.reshape(3, H * H, 32, C // 32)
    np.testing.assert_allclose(mean.numpy(), xr.mean(axis=(1, 3)), **GN_TOL)


def test_group_norm_constant_input_uses_variance_clamp():
    # for a constant 0.01, fp32 E[x^2] - mean^2 rounds below zero; the clamp
    # takes it to 0, so rstd = 1/sqrt(eps) and y is the bias, as in
    # _gn_reference (the mean of the constant is exact, so x - mean = 0)
    C = 128
    x = np.full((2, 4, 4, C), 0.01, np.float32)
    xt = torch.from_numpy(x).reshape(2, -1, 32, C // 32)
    raw_var = xt.square().mean(dim=(1, 3)) - xt.mean(dim=(1, 3)) ** 2
    assert (raw_var < 0).all()
    scale = np.linspace(0.5, 1.5, C, dtype=np.float32)
    bias = np.linspace(-1.0, 1.0, C, dtype=np.float32)
    got, _, rstd = group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), groups=32,
                              return_stats=True)
    ref = np.asarray(_gn_reference(x, scale, bias, 32, 1e-6))
    np.testing.assert_allclose(rstd.numpy(), 1e3, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, **GN_TOL)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(bias, x.shape),
                               **GN_TOL)


def test_group_norm_halves_groups_for_narrow_channels():
    x = torch.randn(2, 4, 4, 24)
    scale, bias = torch.ones(24), torch.zeros(24)
    y = group_norm(x, scale, bias, groups=32)
    ref = np.asarray(_gn_reference(x.numpy(), scale.numpy(), bias.numpy(),
                                   8, 1e-6))
    np.testing.assert_allclose(y.numpy(), ref, **GN_TOL)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_refuse_other_devices_and_bad_inputs():
    meta = torch.empty(2, 1, 16, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention(meta, meta, meta)
    xm = torch.empty(2, 4, 4, 64, device="meta")
    wm = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        group_norm(xm, wm, wm)
    q = torch.randn(2, 1, 16, 64)
    with pytest.raises(ValueError, match="one shape"):
        attention(q, q[:, :, :8], q)
    with pytest.raises(ValueError, match="contiguous"):
        attention(q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3))
    x = torch.randn(2, 4, 4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        group_norm(x.transpose(1, 2), torch.ones(64), torch.zeros(64))
    with pytest.raises(TypeError, match="float32"):
        group_norm(x, torch.ones(64, dtype=torch.float64), torch.zeros(64))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("group_norm")
    assert {p.name for p in _build.sources()} == {
        "group_norm.cu", "flash_attention_fwd.cu", "flash_attention_bwd.cu",
        "flash_attention_f32.cu"}
