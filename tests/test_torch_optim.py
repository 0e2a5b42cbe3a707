"""The port's Adam memory knobs and AMSGrad against optax through the JAX
package's ``make_optimizer`` (CPU, float32 parameters): five steps on the
same numpy gradients, parameters and stored moments compared after each."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from uurg_torch.train import optim as TO  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402

SHAPES = {"w": (7, 5), "b": (5,)}
STEPS = 5
LR = 1e-2
# float32 arithmetic in another order (and 1 - b**t rounded apart): the
# parameters after each step; a stored bf16 moment may sit one bf16 step
# apart where its float32 value lies on a rounding boundary
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-2, atol=1e-7)

BF16 = (torch.bfloat16, jnp.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _adam_states(state):
    """The optax moment states (mu, nu[, nu_max]) inside a chain state."""
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append(s)
        elif isinstance(s, tuple):
            for x in s:
                walk(x)
        elif hasattr(s, "inner_state"):
            walk(s.inner_state)

    walk(state)
    assert len(found) == 1
    return found[0]


def _run(name, weight_decay=0.0, amsgrad=False, mu=None, nu=None,
         seed=0):
    params, grads = _data(seed)
    jopt = JO.make_optimizer(name, LR, weight_decay=weight_decay,
                             amsgrad=amsgrad,
                             mu_dtype=mu and mu[1], nu_dtype=nu and nu[1])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = TO.make_optimizer(name, tp.values(), LR,
                             weight_decay=weight_decay, amsgrad=amsgrad,
                             mu_dtype=mu and mu[0], nu_dtype=nu and nu[0])
    for g in grads:
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       err_msg=k, **PARAM_TOL)
    return topt, tp, _adam_states(jstate)


def _moments(topt, tp, jst, keys=("mu", "nu")):
    for k, p in tp.items():
        st = topt.state[p]
        for m in keys:
            want = np.asarray(getattr(jst, m)[k])
            assert st[m].dtype == {jnp.bfloat16: torch.bfloat16}.get(
                want.dtype.type, torch.float32), (k, m)
            np.testing.assert_allclose(st[m].float().numpy(),
                                       want.astype(np.float32),
                                       err_msg=f"{k} {m}", **MOMENT_TOL)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_mu_dtype_alone_matches_optax(wd):
    """optax.scale_by_adam(mu_dtype): the step's update from the float32
    mu, mu stored in bf16 after."""
    topt, tp, jst = _run("adam", weight_decay=wd, mu=BF16)
    assert isinstance(topt, TO.OptaxAdam)
    _moments(topt, tp, jst)


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("mu", [None, BF16])
def test_nu_dtype_matches_optax(name, mu):
    """scale_by_adam_dtypes: both moments stored downcast, the update from
    the rounded moments; coupled decay for adam, decoupled for adamw."""
    topt, tp, jst = _run(name, weight_decay=1e-2, mu=mu, nu=BF16, seed=1)
    _moments(topt, tp, jst)


@pytest.mark.parametrize("mu", [None, BF16])
def test_amsgrad_matches_optax(mu):
    """optax.scale_by_amsgrad: the maximum of the bias-corrected second
    moment (torch's AMSGrad keeps the raw one's)."""
    topt, tp, jst = _run("adam", weight_decay=1e-2, amsgrad=True, mu=mu,
                         seed=2)
    _moments(topt, tp, jst, ("mu", "nu", "nu_max"))


def test_adamw_ignores_amsgrad():
    """The JAX package's AdamW takes no amsgrad; the port's follows."""
    topt, tp, _ = _run("adamw", weight_decay=1e-2, amsgrad=True, seed=3)
    assert type(topt) is torch.optim.AdamW
    assert not topt.param_groups[0]["amsgrad"]
    topt, _, _ = _run("adamw", weight_decay=1e-2, amsgrad=True, nu=BF16,
                      seed=3)
    assert isinstance(topt, TO.OptaxAdam) and not topt.amsgrad


def test_amsgrad_with_nu_dtype_raises_on_both_sides():
    # optax builds the chain (and raises) at init
    with pytest.raises(NotImplementedError, match="amsgrad"):
        JO.make_optimizer("adam", LR, amsgrad=True,
                          nu_dtype=jnp.bfloat16).init({"w": jnp.zeros(2)})
    with pytest.raises(NotImplementedError, match="amsgrad"):
        TO.make_optimizer("adam", [torch.nn.Parameter(torch.zeros(2))], LR,
                          amsgrad=True, nu_dtype=torch.bfloat16)


def test_plain_adam_stays_torch_adam():
    """Without a knob Adam and AdamW are torch.optim's own (fused on the
    card), as before."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert type(TO.make_optimizer("adam", p, LR)) is torch.optim.Adam
    assert type(TO.make_optimizer("adamw", p, LR)) is torch.optim.AdamW


def test_optax_adam_state_round_trips(tmp_path):
    """The moments are plain tensors in the state dict, so a training
    checkpoint resumes them in their dtype."""
    topt, tp, _ = _run("adam", nu=BF16, mu=BF16, seed=4)
    path = tmp_path / "opt.pt"
    torch.save(topt.state_dict(), path)
    fresh = TO.make_optimizer("adam", tp.values(), LR, mu_dtype=BF16[0],
                              nu_dtype=BF16[0])
    fresh.load_state_dict(torch.load(path, weights_only=True))
    for p in tp.values():
        a, b = topt.state[p], fresh.state[p]
        assert a["step"] == b["step"] == STEPS
        assert b["mu"].dtype == b["nu"].dtype == torch.bfloat16
        assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])
