"""``nsfw_removal`` on two gloo ranks (CPU, float32, SD's tiny UNet at 32
channels and 8 x 8 latents, a packed mask): one step under ``dp`` and
under ``fsdp`` against one process, with SGD and with the runner's own
Adam (first moment in bf16), the packed mask whole, the optimizer state
sharded like the parameters, and the UNet written whole by rank 0 through
``save_unet``, read back and trained on from under two ranks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_parallel_ranks as PR  # noqa: E402
from uurg_torch.io.sd_interop import compvis_unet_to_torch  # noqa: E402
from uurg_torch.parallel.mesh import fsdp_spec  # noqa: E402

# one SGD step of float32 gradients over half the rows a rank, averaged
PARAM_ABS = 2e-6
# Adam's step: the DiT FSDP step's bounds on the parameters; its moments
# leaf by leaf at one bf16 step (mu) or 2e-4 (nu, float32) of the value,
# plus 2e-4 of the largest moment of the model (a float32 gradient summed
# in another order)
ADAM_RTOL, ADAM_ATOL = 2e-4, 2e-5
MOMENT_RTOL, MOMENT_SCALE = {"mu": 2**-7, "nu": 2e-4}, 2e-4
B, LATENT, CTX = 4, 8, (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(rng, n_ctx):
    return (torch.from_numpy(rng.standard_normal((B, LATENT, LATENT, 4))
                             .astype(np.float32)),
            *(torch.from_numpy(rng.standard_normal((B, *CTX))
                               .astype(np.float32)) for _ in range(n_ctx)))


def _check_adam(got, want, state):
    """The sharded Adam step against one process: the parameters, and the
    two moments gathered whole."""
    for k, w in want["params"].items():
        torch.testing.assert_close(got["params"][k], w, rtol=ADAM_RTOL,
                                   atol=ADAM_ATOL, msg=k)
    assert max(float((w - state[k]).abs().max())
               for k, w in want["params"].items()) > 1e-4
    for i, kind in enumerate(("mu", "nu")):
        top = max(float(m[i].float().abs().max())
                  for m in want["moments"].values())
        assert top > 0
        for k, m in want["moments"].items():
            g = got["moments"][k][i]
            assert g.dtype == m[i].dtype == (torch.bfloat16 if kind == "mu"
                                             else torch.float32)
            torch.testing.assert_close(
                g.float(), m[i].float(), rtol=MOMENT_RTOL[kind],
                atol=MOMENT_SCALE * top, msg=f"{kind} of {k}")


def test_nsfw_removal_two_ranks(tmp_path):
    rng = np.random.default_rng(0)
    model = PR.sd_workload().init_unet(0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mask = {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
            for n, p in model.named_parameters()}
    ranks_dir = tmp_path / "ranks"
    ranks_dir.mkdir()
    inputs = {"tmp": str(ranks_dir), "state": state, "mask": mask,
              "forget": [_batch(rng, 2)], "remain": [_batch(rng, 1)]}
    torch.save(inputs, tmp_path / "in.pt")
    PR.spawn("sd", 2, tmp_path, str(tmp_path / "in.pt"))
    one = dict(inputs, tmp=str(tmp_path))
    ref = PR.sd_run(one, None, "dp")
    ref_adam = PR.sd_run(one, None, "dp", adam=True)
    resumed = PR.sd_resumed(one, ref["path"], None)
    moved = max(float((ref["params"][k] - state[k]).abs().max())
                for k in ref["params"])
    assert moved > 1e-5
    for r in range(2):
        got = torch.load(tmp_path / f"sd_rank{r}.pt", weights_only=False)
        for kind, want in (("dp", ref), ("fsdp", ref),
                           ("resumed", resumed)):
            g = got[kind]
            dev = max(float((g["params"][k] - want["params"][k]).abs().max())
                      for k in want["params"])
            assert dev < PARAM_ABS, kind
            assert g["packed"]
        # the UNet is written once, whole, and reads back as it was
        back = compvis_unet_to_torch(
            torch.load(got["fsdp"]["path"])["state_dict"],
            PR.sd_workload().unet_cfg)
        assert set(back) == set(got["fsdp"]["params"])
        for k, v in back.items():
            assert torch.equal(v, got["fsdp"]["params"][k]), k
        for kind in ("dp", "fsdp", "fsdp_adam"):
            for name, (n_param, n_state) in got[kind]["sizes"].items():
                numel = state[name].numel()
                sharded = kind != "dp" and fsdp_spec(
                    tuple(state[name].shape), 2) is not None
                part = numel // 2 if sharded else numel
                assert n_param == n_state == part, (kind, name)
        assert any(n < state[k].numel()
                   for k, (n, _) in got["fsdp"]["sizes"].items())
        _check_adam(got["fsdp_adam"], ref_adam, state)
    assert sorted(p.name for p in ranks_dir.iterdir()) == [
        "resumed", "sd_dp_sgd_2.pt", "sd_fsdp_adam_2.pt", "sd_fsdp_sgd_2.pt"]
    # the run resumed from the fsdp run's file moved on from it
    back = compvis_unet_to_torch(
        torch.load(ranks_dir / "sd_fsdp_sgd_2.pt")["state_dict"],
        PR.sd_workload().unet_cfg)
    assert any(not torch.equal(resumed["params"][k], back[k]) for k in back)
