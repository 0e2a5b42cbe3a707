"""``uurg_torch/utils/profiling.py`` on the CPU, and the CLIs' ``--profile_dir``
behind it: ``maybe_trace`` writes ``trace.json`` (a Chrome trace of
``torch.profiler``) and does nothing on ``""``; ``StepTimer`` and
``timed`` wait for no device on CPU tensors; ``train``, ``forget`` and
``nsfw_removal`` each write a trace of a one-iteration run at tiny sizes;
``--rng_impl`` still raises (the port draws from torch generators)."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tests.test_torch_dit_runner import CLI as DIT_CLI  # noqa: E402
from tests.test_torch_dit_runner import _shards  # noqa: E402
from tests.test_torch_sd_interop import tiny_cli  # noqa: E402,F401
from tests.test_torch_sd_methods_cli import COMMON as SD_COMMON  # noqa: E402
from tests.test_torch_sfron import _tiny_config  # noqa: E402
from uurg_torch import utils  # noqa: E402
from uurg_torch.utils import profiling as P  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trace_events(folder) -> list:
    with open(os.path.join(folder, "trace.json")) as f:
        return json.load(f)["traceEvents"]


def test_maybe_trace_writes_a_chrome_trace_and_nothing_when_off(tmp_path):
    out = tmp_path / "prof"
    with P.maybe_trace(str(out)) as where:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert where == str(out)
    names = {e.get("name") for e in _trace_events(out)}
    assert "aten::mm" in names
    with P.maybe_trace("") as where:
        torch.ones(3).sum()
    assert where is None and sorted(os.listdir(tmp_path)) == ["prof"]


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with P.trace(str(tmp_path)):
            torch.ones(3).sum()
            1 / 0
    assert _trace_events(tmp_path)


def test_step_timer_and_timed_on_the_cpu(monkeypatch):
    """CPU tensors and modules need no wait: torch.cuda.synchronize is
    never called. The package exports them as the JAX package does."""
    def no_card(*a, **k):
        raise AssertionError("synchronize on CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    assert (utils.StepTimer, utils.timed, utils.trace) == (
        P.StepTimer, P.timed, P.trace)
    model = torch.nn.Linear(4, 4)
    timer = P.StepTimer()
    timer.start(sync_on=model)
    for _ in range(3):
        model(torch.ones(2, 4))
        timer.tick()
    timer.tick(2)
    assert timer._steps == 5
    assert 0 < timer.rate(sync_on={"w": [model.weight], "x": (1, None)})
    out, secs = P.timed(lambda a, b=1: (a * b, [a]), torch.ones(3), b=2)
    assert torch.equal(out[0], torch.full((3,), 2.0)) and secs >= 0
    _, secs = P.timed(np.zeros, 3, sync=False)
    assert secs >= 0


def test_wait_for_synchronizes_each_cuda_device_once(monkeypatch):
    """The devices are read from the tensors without touching their data:
    stand-ins that carry only a device play CUDA tensors here."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)

    class Fake:
        def __init__(self, dev):
            self.device = torch.device(dev)

    monkeypatch.setattr(torch, "is_tensor", lambda x: isinstance(x, Fake))
    P.wait_for([Fake("cuda:0"), {"a": (Fake("cuda:1"), Fake("cuda:0"))},
                Fake("cpu")])
    assert sorted(str(d) for d in seen) == ["cuda:0", "cuda:1"]


def test_train_cli_profile_dir_writes_a_trace(tmp_path):
    pytest.importorskip("yaml")
    import yaml

    from uurg_torch.cli import train as cli

    cfg = _tiny_config(tmp_path, n_iters=1)
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    cli.main(["--config", str(cfg_path), "--exp", str(tmp_path / "exp"),
              "--device", "cpu", "--mode", "sfron", "--n_iters", "1",
              "--profile_dir", str(tmp_path / "prof")])
    names = {e.get("name") for e in _trace_events(tmp_path / "prof")}
    assert "aten::convolution" in names
    assert list((tmp_path / "exp").rglob("ckpt.pth"))
    # the one flag of the JAX CLI the port still refuses
    with pytest.raises(NotImplementedError, match="rng_impl"):
        cli.main(["--config", str(cfg_path), "--device", "cpu",
                  "--rng_impl", "rbg"])


def test_forget_cli_profile_dir_writes_a_trace(tmp_path):
    from uurg_torch.cli import forget

    forget.main([*DIT_CLI, "--data-path", _shards(tmp_path), "--n-iters",
                 "1", "--results-dir", str(tmp_path / "res"),
                 "--profile_dir", str(tmp_path / "prof")])
    names = {e.get("name") for e in _trace_events(tmp_path / "prof")}
    assert "aten::linear" in names or "aten::addmm" in names


def test_nsfw_removal_cli_profile_dir_writes_a_trace(tmp_path,
                                                     tiny_cli):  # noqa: F811
    from uurg_torch.cli import nsfw_removal

    nsfw_removal.main([*SD_COMMON, "--n_iters", "1", "--snapshot_freq", "5",
                       "--nsfw_data", str(tmp_path / "none"),
                       "--not_nsfw_data", str(tmp_path / "none"),
                       "--save_path", str(tmp_path / "out"),
                       "--profile_dir", str(tmp_path / "prof")])
    names = {e.get("name") for e in _trace_events(tmp_path / "prof")}
    assert "aten::convolution" in names
    assert (tmp_path / "out" / "final.pt").is_file()
