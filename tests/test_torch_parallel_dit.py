"""FSDP on gloo ranks for the DiT workload (CPU, float32): the depth-2
DiT-S/2 SFR-on step on a ``data=2`` mesh (ZeRO over ``data``) and on a
``data=2,model=2`` mesh against one process, with the Adam moments, the
EMA shadow and a dense mask sharded like the parameters and a packed mask
whole; ``dit_forget`` under FSDP, its train state written whole by rank 0
and resumed; ``dit_sample_fid``'s rank striding.

The model is DiT's own init (adaLN-Zero), as the JAX package's sharded
step test takes it: with every weight perturbed, Adam's first steps turn
the rounding of gradients that are zero in exact arithmetic (the
attention's k bias) into +-lr moves of either sign on each side."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_parallel_ranks as PR  # noqa: E402
from uurg_torch.parallel.mesh import fsdp_spec  # noqa: E402

# tests/test_parallel.py's bounds for the sharded DiT step
RTOL, ATOL, LOSS_REL = 2e-4, 2e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(rng, n=8):
    return (torch.from_numpy(rng.standard_normal((n, 8, 8, 4))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, n)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dit")
    rng = np.random.default_rng(0)
    model = PR.dit_workload().init_params(0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mask = {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
            for n, p in model.named_parameters()}
    out = {"state": state, "mask": mask,
           "batches": [(_batch(rng), _batch(rng)) for _ in range(2)],
           "batches_f": [_batch(rng) for _ in range(2)],
           "batches_r": [_batch(rng) for _ in range(2)]}
    torch.save(out, tmp / "in.pt")
    return tmp, out


def _close(got, want, **kw):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **kw)


def _check_step(got, ref, axis_size, min_size=64):
    for kind in ("dense", "packed"):
        g = got[kind]
        _close(g["params"], ref["params"], rtol=RTOL, atol=ATOL)
        _close(g["ema"], ref["ema"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["losses"], ref["losses"], rtol=LOSS_REL)
        assert g["packed"] == (kind == "packed")
        for name, sizes in g["sizes"].items():
            numel = ref["params"][name].numel()
            sharded = fsdp_spec(tuple(ref["params"][name].shape), axis_size,
                                min_size) is not None
            # the parameter, its Adam moment, its shadow and its dense mask
            # hold 1/axis_size of the elements when it is sharded
            part = numel // axis_size if sharded else numel
            want_sizes = (part, part, part, None if kind == "packed"
                          else part)
            assert sizes == want_sizes, name
    assert any(s[0] < ref["params"][n].numel()
               for n, s in got["dense"]["sizes"].items())
    for have, want in zip(got["dense"]["exp_avg"], ref["exp_avg"]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_dit_fsdp_step_two_ranks(inputs):
    tmp, data = inputs
    PR.spawn("dit_step", 2, tmp, str(tmp / "in.pt"), "data=2")
    ref = PR.dit_step_run(data, None)
    got = [torch.load(tmp / f"dit_step_rank{r}.pt", weights_only=False)
           for r in range(2)]
    for r in range(2):
        _check_step(got[r], ref, 2)


def test_dit_fsdp_step_data2_model2(inputs):
    # FSDP2's hybrid form: replicated over data, sharded over model, the
    # batch split over data only
    tmp, data = inputs
    PR.spawn("dit_step", 4, tmp, str(tmp / "in.pt"), "data=2,model=2")
    ref = PR.dit_step_run(data, None)
    for r in range(4):
        _check_step(torch.load(tmp / f"dit_step_rank{r}.pt",
                               weights_only=False), ref, 2)


def test_dit_forget_fsdp_two_ranks_and_sample_fid(inputs):
    """dit_forget under FSDP on two ranks equals one process, straight and
    cut after one step and resumed from train_state.pt, which rank 0 alone
    writes whole; dit_sample_fid gives rank r the labels [r::2] from seed
    9 + r."""
    tmp, data = inputs
    PR.spawn("dit_runner", 2, tmp, str(tmp / "in.pt"), str(tmp / "ranks"))
    one = str(tmp / "one")
    ref = {"straight": PR.dit_runner_run(data, None, 2, None),
           "first": PR.dit_runner_run(data, one, 1, None),
           "resumed": PR.dit_runner_run(data, one, 2, None)}
    full = torch.load(tmp / "ranks" / "dit_ckpt" / "train_state.pt",
                      weights_only=True)
    for k, v in full["model"].items():
        assert v.shape == data["state"][k].shape, k
    assert full["step"] == 2
    from uurg_torch.workloads.dit_runner import dit_sample_fid

    labels = np.arange(6) % 10
    for r in range(2):
        got = torch.load(tmp / f"dit_runner_rank{r}.pt", weights_only=False)
        for run in ref:
            for k in ("params", "ema"):
                _close(got[run][k], ref[run][k], rtol=RTOL, atol=ATOL)
        writers = {w for run in ("first", "resumed")
                   for w, _ in got[run]["writes"]}
        assert writers == ({0} if r == 0 else set())
        want = dit_sample_fid(PR.dit_workload(), PR.dit_model(data["state"]),
                              labels[r::2], respacing="3", batch_size=2,
                              seed=9 + r)
        assert got["latents"].shape == want.shape == (3, 8, 8, 4)
        np.testing.assert_array_equal(got["latents"], want)
