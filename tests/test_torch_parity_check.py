"""The port's twin of cli/parity_check.py: all five stages of the
north-star run (Fisher -> mask -> SFR-on -> sampling -> metrics) at the
--quick scale on the CPU, on stand-in artifacts, and its constants and
flags against the JAX kit."""
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from uurg_torch.cli import parity_check as TP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFRON = os.path.join(ROOT, "configs", "cifar10_sfron.yml")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (as tests/
    test_torch_fisher.py): the suite's workers share one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_kit():
    # the JAX kit imports JAX only inside main()
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", os.path.join(ROOT, "cli", "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(tmp_path, *extra):
    return ["--artifacts", str(tmp_path / "no_artifacts_here"),
            "--out", str(tmp_path / "parity"), "--config", SFRON, *extra]


def test_quick_standin_runs_all_five_stages(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        TP.main(_argv(tmp_path, "--quick", "--device", "cpu"))
    assert exc.value.code == 0         # stand-ins: every band SKIPPED
    out = tmp_path / "parity"
    with open(out / "parity_report.json") as f:
        rep = json.load(f)
    assert rep["real_run"] is False
    assert all(v is None for v in rep["artifacts"].values())
    statuses = {r["metric"]: r["status"] for r in rep["report"]}
    assert set(statuses) == set(TP.BANDS)
    assert all(s.startswith("SKIPPED") for s in statuses.values())
    m = rep["metrics"]
    assert all(np.isfinite(m[k]) for k in TP.BANDS)
    assert m["inception_score"] >= 1.0 and m["fid"] > 0 and m["sfid"] > 0
    assert all(0.0 <= m[k] <= 1.0 for k in ("precision", "recall",
                                            "forget_accuracy"))
    for name, n in (("samples.npz", 90), ("probe_samples.npz", 32)):
        imgs = np.load(out / name)["arr_0"]
        assert imgs.shape == (n, 32, 32, 3) and imgs.dtype == np.uint8
    assert (out / "fisher" / "fisher_1.0").is_file()
    assert (out / "unlearned" / "ckpt.pth").is_file()
    table = capsys.readouterr().out
    assert table.count("SKIPPED") == len(TP.BANDS)


@pytest.mark.parametrize("flag", [["--nu_dtype", "bf16"], ["--remat"]])
def test_unported_flags_raise(tmp_path, flag, monkeypatch):
    """Both flags were refused before they were ported; now each reaches
    the stages: --remat as the config's model.remat, --nu_dtype bf16 as the
    SFR-on stage's Adam second-moment dtype (the Fisher stage, stubbed
    here to stop the run, receives both)."""
    from uurg_torch.workloads import ddpm_runner

    seen = {}

    def stop(run_args, config, out, device=None):
        seen.update(remat=config.model.get("remat", False),
                    nu_dtype=run_args.nu_dtype)
        raise KeyboardInterrupt

    monkeypatch.setattr(ddpm_runner, "generate_fisher", stop)
    with pytest.raises(KeyboardInterrupt):
        TP.main(_argv(tmp_path, "--quick", "--device", "cpu", *flag))
    assert seen == ({"remat": True, "nu_dtype": None} if flag == ["--remat"]
                    else {"remat": False, "nu_dtype": torch.bfloat16})


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.main(_argv(tmp_path, "--quick"))


def test_bands_and_artifact_names_match_the_jax_kit(tmp_path):
    jax_kit = _jax_kit()
    assert TP.BANDS == jax_kit.BANDS
    assert TP.find_artifacts(str(tmp_path)) == jax_kit.find_artifacts(
        str(tmp_path))
    for name in ("cifar-10-batches-py", "ckpts/ckpt.pth",
                 "pt_inception-2015-12-05.pth", "resnet34_classifier.pth"):
        os.makedirs(os.path.dirname(tmp_path / name), exist_ok=True)
        (tmp_path / name).touch()
        assert TP.find_artifacts(str(tmp_path)) == jax_kit.find_artifacts(
            str(tmp_path))
    (tmp_path / "ckpt.pth").touch()     # ckpts/ckpt.pth still comes first
    assert TP.find_artifacts(str(tmp_path)) == jax_kit.find_artifacts(
        str(tmp_path))
    assert all(TP.find_artifacts(str(tmp_path)).values())
