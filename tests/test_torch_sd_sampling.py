"""The port's SD samplers (``ddim_sample_till``, ``plms_sample``,
``lms_coefficients``, ``lms_sample``) vs the JAX package's (CPU), on SD's
``quad`` schedule and an analytic eps function written twice, once in each
framework, so that only the samplers differ."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.diffusion import sampling as TS  # noqa: E402
from uurg_torch.diffusion.schedules import make_schedule  # noqa: E402
from uurg_tpu.diffusion import sampling as JS  # noqa: E402
from uurg_tpu.diffusion import schedules as JSch  # noqa: E402

SCHEDULE = ("quad", 0.00085, 0.012, 1000)
# float32 on both sides through the same arithmetic, sums of a few terms in
# another order
SAMPLE_TOL = 1e-6
COEFF_TOL = 1e-12


def _eps_jax(x, t):
    s = t.astype(jnp.float32)[:, None, None, None] / 1000.0
    return 0.3 * jnp.tanh(x) * jnp.cos(3.0 * s) + 0.05 * s


def _eps_torch(x, t):
    s = t.float()[:, None, None, None] / 1000.0
    return 0.3 * torch.tanh(x) * torch.cos(3.0 * s) + 0.05 * s


def _x(seed: int = 0):
    return np.random.default_rng(seed).standard_normal(
        (3, 4, 4, 4)).astype(np.float32)


def _both(steps: int):
    seq = JS.make_step_sequence(1000, steps, offset=1)
    np.testing.assert_array_equal(seq, TS.make_step_sequence(1000, steps,
                                                             offset=1))
    return seq, JSch.make_schedule(*SCHEDULE), make_schedule(*SCHEDULE)


def _close(got, want, tol=SAMPLE_TOL):
    got, want = got.numpy(), np.asarray(want)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("steps,till", [(10, 0), (10, 1), (10, 4),
                                        (10, 10), (7, 3)])
def test_ddim_sample_till_matches_jax(steps, till):
    seq, js, ts = _both(steps)
    x = _x(1)
    want = JS.ddim_sample_till(_eps_jax, js, jnp.asarray(x), seq, till)
    got = TS.ddim_sample_till(_eps_torch, ts, torch.from_numpy(x), seq, till)
    _close(got, want)


def test_ddim_sample_till_zero_is_the_whole_chain():
    seq, _, ts = _both(10)
    x = torch.from_numpy(_x(2))
    assert torch.equal(TS.ddim_sample_till(_eps_torch, ts, x, seq, 0),
                       TS.ddim_sample(_eps_torch, ts, x, seq))


@pytest.mark.parametrize("steps", [1, 2, 4, 5, 10])
def test_plms_sample_matches_jax(steps):
    # 1, 2 and 4 steps cover the warm-up and each Adams-Bashforth order (3
    # steps would sample t = 1000, past the schedule: JAX clamps the index,
    # the port raises IndexError, as the torch reference does)
    seq, js, ts = _both(steps)
    x = _x(3)
    want = JS.plms_sample(_eps_jax, js, jnp.asarray(x), seq)
    got = TS.plms_sample(_eps_torch, ts, torch.from_numpy(x), seq)
    _close(got, want)


@pytest.mark.parametrize("order", [1, 2, 4])
def test_lms_coefficients_match_jax(order):
    sig = np.concatenate([np.linspace(14.6, 0.03, 9) ** 1.3, [0.0]])
    got = TS.lms_coefficients(sig, order)
    want = JS.lms_coefficients(sig, order)
    assert got.dtype == np.float64 and got.shape == (9, order)
    np.testing.assert_allclose(got, want, rtol=0, atol=COEFF_TOL)


@pytest.mark.parametrize("steps", [1, 4, 12])
def test_lms_sample_matches_jax(steps):
    _, js, ts = _both(steps)
    x = _x(4)
    seen = []

    def eps_t(x, t):
        seen.append(t)
        return _eps_torch(x, t)

    want = JS.lms_sample(_eps_jax, js, jnp.asarray(x), steps)
    got = TS.lms_sample(eps_t, ts, torch.from_numpy(x), steps)
    _close(got, want)
    # the model sees float32 timesteps on the interpolated grid
    assert all(t.dtype == torch.float32 for t in seen)
    np.testing.assert_allclose([float(t[0]) for t in seen],
                               np.linspace(999, 0, steps), rtol=1e-6)
