"""uurg_torch CondUNet vs the JAX CondUNet on the same weights (CPU, fp32),
and the weight mapping from Flax params to the reference torch names."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.io.jax_interop import jax_unet_params_to_torch  # noqa: E402
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_tpu.io.torch_interop import flax_unet_params_to_torch  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402

# tiny: one attention site at 16x16 (T=256), the mid site at 8x8 (T=64)
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
            dropout=0.0, resolution=32)
# fp32 end to end; the sums of ~20 conv layers differ in order only
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    c = rng.integers(0, 10, n).astype(np.int32)
    keep = np.arange(n) % 2 == 0                      # mixed cond / null class
    return x, t, c, keep


def _port(params, **cfg):
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **cfg))
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    return model.eval()


def _forward_both(cfg, params, n, seed):
    x, t, c, keep = _inputs(n, seed)
    jmodel = JU.CondUNet(JU.UNetConfig(dtype=jnp.float32, **cfg))
    want = np.asarray(jmodel.apply({"params": params}, x, t, c, keep))
    with torch.inference_mode():
        got = _port(params, **cfg)(
            torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(c).long(), torch.from_numpy(keep)).numpy()
    return got, want


@pytest.fixture(scope="module")
def tiny_params():
    _, params = JU.init_unet(jax.random.key(0),
                             JU.UNetConfig(dtype=jnp.float32, **TINY))
    return params


def test_tiny_unet_forward_matches_jax(tiny_params):
    got, want = _forward_both(TINY, tiny_params, 4, seed=1)
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_full_width_unet_forward_matches_jax():
    _, params = JU.init_unet(jax.random.key(1), JU.UNetConfig(dtype=jnp.float32))
    got, want = _forward_both({}, params, 1, seed=2)
    np.testing.assert_allclose(got, want, **TOL)


def test_param_mapping_matches_jax_interop(tiny_params):
    mine = jax_unet_params_to_torch(tiny_params)
    ref = flax_unet_params_to_torch(tiny_params)
    assert set(mine) == set(ref)
    for k, v in ref.items():
        assert mine[k].dtype == torch.float32
        np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **TINY))
    assert set(model.state_dict()) == set(mine)
    model.load_state_dict(mine, strict=True)


def test_full_width_parameter_count_and_init():
    model = TU.init_unet(0, TU.UNetConfig())
    assert sum(p.numel() for p in model.parameters()) == 38_632_323
    # Flax defaults: lecun-normal kernels (std 1/sqrt(fan_in), |w| <= 2 of
    # the untruncated std), zero biases, GroupNorm 1/0, null class N(0, 1)
    w = model.down[1].block[0].conv1.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.02
    assert w.abs().max().item() <= 2 / 0.87962566103423978 / fan_in ** 0.5
    assert model.down[1].block[0].conv1.bias.abs().max().item() == 0
    assert model.mid.attn_1.norm.weight.eq(1).all()
    a, b = (TU.init_unet(3, TU.UNetConfig(dtype=torch.float32, **TINY))
            for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k                 # same seed, same weights
