"""Tensor parallel on two gloo ranks through the runners (CPU, float32):
``nsfw_removal`` on SD's tiny UNet at 32 channels (two heads, one on each
rank; the convolutions FSDP-sharded over the same axis) with a packed and
with a dense mask, and under the runner's Adam, against one process; and
``dit_forget`` on the depth-2 DiT-S/2, its ``final.pt`` and
``train_state.pt`` written whole by rank 0, the checkpoint read on one
device, a run resumed from the train state equal to an unbroken one."""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_parallel_ranks as PR  # noqa: E402
from tests.test_torch_parallel_sd import B, CTX, LATENT  # noqa: E402
from tests.test_torch_parallel_sd import _check_adam  # noqa: E402
from uurg_torch.io.dit_interop import load_dit_reference_checkpoint  # noqa: E402
from uurg_torch.io.sd_interop import compvis_unet_to_torch  # noqa: E402
from uurg_torch.parallel.mesh import SD_TP_RULES, tp_param_specs  # noqa: E402

# tests/test_tensor_parallel.py's bounds for a tensor-parallel step
RTOL, ATOL = 2e-4, 2e-5


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


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {k}")


def test_nsfw_removal_tp_two_ranks(tmp_path):
    rng = np.random.default_rng(1)
    model = PR.sd_workload().init_unet(0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mask = {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
            for n, p in model.named_parameters()}
    ranks_dir = tmp_path / "ranks"
    ranks_dir.mkdir()
    inputs = {"tmp": str(ranks_dir), "state": state, "mask": mask,
              "forget": [_batch(rng, 2)], "remain": [_batch(rng, 1)]}
    torch.save(inputs, tmp_path / "in.pt")
    PR.spawn("sd_tp", 2, tmp_path, str(tmp_path / "in.pt"))
    one = dict(inputs, tmp=str(tmp_path))
    ref = {"packed": PR.sd_run(one, None, "dp"),
           "dense": PR.sd_run(one, None, "dp", pack=False),
           "adam": PR.sd_run(one, None, "dp", adam=True)}
    assert max(float((ref["dense"]["params"][k] - state[k]).abs().max())
               for k in state) > 1e-5
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(2,))
    specs = tp_param_specs(model, mesh, SD_TP_RULES, fallback="fsdp")
    kinds = {s.kind for s in specs.values() if s is not None}
    assert kinds == {"tp", "fsdp"}
    for r in range(2):
        got = torch.load(tmp_path / f"sd_tp_rank{r}.pt", weights_only=False)
        for kind in ("packed", "dense"):
            g = got[kind]
            _close(g["params"], ref[kind]["params"], kind)
            assert g["packed"] == (kind == "packed")
            assert g["momentum"].keys() == ref[kind]["momentum"].keys()
            for i, want in ref[kind]["momentum"].items():
                np.testing.assert_allclose(g["momentum"][i].numpy(),
                                           want.numpy(), rtol=RTOL,
                                           atol=ATOL)
            # the rules' and the fallback's parameters and their momenta
            # hold half the elements on each rank, the rest all of them
            for name, sizes in g["sizes"].items():
                part = state[name].numel() // (1 if specs[name] is None
                                               else 2)
                assert sizes == (part, part), (kind, name)
        _check_adam(got["adam"], ref["adam"], state)
        # the UNet is written once, whole, and reads back as it was
        back = compvis_unet_to_torch(
            torch.load(got["dense"]["path"])["state_dict"],
            PR.sd_workload().unet_cfg)
        for k, v in back.items():
            assert torch.equal(v, got["dense"]["params"][k]), k
    assert sorted(p.name for p in ranks_dir.iterdir()) == [
        "sd_tp_adam_2.pt", "sd_tp_sgd_2.pt", "sd_tp_sgd_dense_2.pt"]


def test_dit_forget_tp_checkpoint_and_resume(tmp_path):
    rng = np.random.default_rng(2)
    model = PR.dit_workload().init_params(0)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def batch():
        return (torch.from_numpy(rng.standard_normal((4, 8, 8, 4))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, 4)))

    inputs = {"state": state,
              "mask": {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
                       for n, p in model.named_parameters()},
              # one batch a stream, every step: a run resumed at step 1
              # reads what the unbroken one read there
              "batches_f": [batch()] * 2, "batches_r": [batch()] * 2}
    torch.save(inputs, tmp_path / "in.pt")
    PR.spawn("dit_tp_runner", 2, tmp_path, str(tmp_path / "in.pt"),
             str(tmp_path / "ranks"))
    one = str(tmp_path / "one")
    ref = {"straight": PR.dit_runner_run(inputs, None, 2, None),
           "first": PR.dit_runner_run(inputs, one, 1, None)}
    ckpt = tmp_path / "ranks" / "dit_tp_ckpt"
    assert sorted(os.listdir(ckpt)) == ["ckpt_0000000.pt", "ckpt_0000001.pt",
                                        "final.pt", "train_state.pt"]
    full = torch.load(ckpt / "train_state.pt", weights_only=True)
    assert full["step"] == 2
    for k, v in full["model"].items():
        assert v.shape == state[k].shape, k
    # final.pt, written under tensor parallel, read on one device
    loaded = PR.dit_model(state)
    load_dit_reference_checkpoint(str(ckpt / "final.pt"), loaded)
    got_ema = dict(loaded.named_parameters())
    for r in range(2):
        got = torch.load(tmp_path / f"dit_tp_runner_rank{r}.pt",
                         weights_only=False)
        for run in ("straight", "first"):
            for k in ("params", "ema"):
                _close(got[run][k], ref[run][k], f"{run} {k}")
        # the run resumed from train_state.pt equals the unbroken one
        for k in ("params", "ema"):
            for name, v in got["straight"][k].items():
                assert torch.equal(got["resumed"][k][name], v), (k, name)
        writers = {w for run in ("first", "resumed")
                   for w, _ in got[run]["writes"]}
        assert writers == ({0} if r == 0 else set())
        for name, v in got["resumed"]["ema"].items():
            assert torch.equal(got_ema[name].detach(), v), name
