"""The port's membership-inference solvers against scikit-learn, which the
JAX package calls and the card's machine lacks, and the two
classification CLIs of the port on the CPU at a tiny size.

- ``fit_logistic`` against ``LogisticRegression(class_weight="balanced",
  solver="lbfgs")``: coefficients within 1e-4 relative, the predicted
  member fraction equal.
- ``fit_svc`` against ``SVC(C=3, gamma="auto", kernel="rbf")`` on 1-D
  features: attack accuracy within 0.005 and predictions equal on at
  least 99% of the target points, from 200 to the protocol's cap of 4000
  a side.
Both on seeded overlapping features, ties (repeated values) and separable
features; one class alone raises on both sides.
"""
import csv
import json
import os

import numpy as np
import pytest

sklearn = pytest.importorskip("sklearn")
torch = pytest.importorskip("torch")

from sklearn.linear_model import LogisticRegression  # noqa: E402
from sklearn.svm import SVC  # noqa: E402

from uurg_torch.eval import mia as M  # noqa: E402

LR_COEF_REL = 1e-4
SVC_ACC = 0.005
SVC_AGREE = 0.99


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _features(kind: str, n: int, seed: int):
    """(x (2n, 1) float32, y: n ones then n zeros, targets (1000, 1))."""
    rng = np.random.default_rng(seed)
    if kind == "overlap":
        a, b = rng.normal(0.0, 1.0, n), rng.normal(0.8, 1.2, n)
    elif kind == "ties":          # features on a grid of 12 values
        a = np.round(rng.normal(0.0, 1.0, n) * 2) / 2
        b = np.round(rng.normal(0.7, 1.0, n) * 2) / 2
    else:                         # separable
        a, b = rng.uniform(0.0, 1.0, n), rng.uniform(1.5, 2.5, n)
    x = np.concatenate([a, b]).astype(np.float32).reshape(-1, 1)
    y = np.concatenate([np.ones(n), np.zeros(n)])
    t = rng.normal(0.4, 1.3, 1000).astype(np.float32).reshape(-1, 1)
    if kind == "ties":
        t = np.round(t * 2) / 2
    return x, y, t


@pytest.mark.parametrize("kind", ["overlap", "ties", "separable"])
@pytest.mark.parametrize("n", [200, 1000, 4000])
def test_logistic_matches_sklearn(kind, n):
    x, y, t = _features(kind, n, seed=n)
    ref = LogisticRegression(class_weight="balanced", solver="lbfgs").fit(
        x, y)
    coef, intercept, classes = M.fit_logistic(x, y)
    want = np.concatenate([ref.coef_.ravel(), ref.intercept_])
    got = np.concatenate([coef, [intercept]])
    assert np.abs(got - want).max() <= LR_COEF_REL * np.abs(want).max()
    pred = classes[(t @ coef + intercept > 0).astype(np.int64)]
    assert pred.mean() == ref.predict(t).mean()


@pytest.mark.parametrize("kind", ["overlap", "ties", "separable"])
@pytest.mark.parametrize("n", [200, 1000, 4000])
def test_svc_matches_sklearn(kind, n):
    x, y, t = _features(kind, n, seed=n + 1)
    want = SVC(C=3, gamma="auto", kernel="rbf").fit(x, y).predict(t)
    got = M.fit_svc(x, y)(t)
    assert abs(got.mean() - want.mean()) <= SVC_ACC
    assert (got == want).mean() >= SVC_AGREE


def test_one_class_raises_on_both_sides():
    x = np.linspace(0, 1, 20, dtype=np.float32).reshape(-1, 1)
    y = np.ones(20)
    for fit in (lambda: LogisticRegression().fit(x, y),
                lambda: SVC().fit(x, y), lambda: M.fit_logistic(x, y),
                lambda: M.fit_svc(x, y)):
        with pytest.raises(ValueError):
            fit()


def test_attacks_on_probabilities_match_the_sklearn_attacks():
    """``membership_attack_prob`` and ``svc_mia`` on softmax outputs, as
    the protocol calls them, against the same attacks through
    scikit-learn."""
    from uurg_torch.eval.features import confidence, entropy, m_entropy
    from uurg_torch.eval.features import softmax

    rng = np.random.default_rng(7)

    def probs(n, sharp):
        logits = rng.normal(0, 1, (n, 10)) + sharp * np.eye(10)[
            rng.integers(0, 10, n)]
        return softmax(logits.astype(np.float32)), rng.integers(0, 10, n)

    (rp, rl), (fp, fl), (tp, tl) = probs(600, 4.0), probs(150, 3.0), \
        probs(400, 2.0)
    got = M.membership_attack_prob(rp, rl, fp, fl, tp, tl)
    x = np.concatenate([entropy(rp), entropy(tp)]).reshape(-1, 1)
    y = np.concatenate([np.ones(600), np.zeros(400)])
    ref = LogisticRegression(class_weight="balanced", solver="lbfgs").fit(
        x, y)
    assert got == ref.predict(entropy(fp).reshape(-1, 1)).mean()

    empty = (np.zeros((0, 10)), np.zeros((0,), np.int64))
    got = M.svc_mia((rp[:400], rl[:400]), (tp, tl), empty, (fp, fl))
    for name, feat in (("confidence", confidence),
                       ("entropy", lambda p, lab: entropy(p)),
                       ("m_entropy", m_entropy)):
        xs = np.concatenate([feat(rp[:400], rl[:400]),
                             feat(tp, tl)]).reshape(-1, 1)
        ys = np.concatenate([np.ones(400), np.zeros(400)])
        ref = SVC(C=3, gamma="auto", kernel="rbf").fit(xs, ys)
        want = 1 - ref.predict(feat(fp, fl).reshape(-1, 1)).mean()
        assert abs(got[name] - want) <= SVC_ACC, name


# -- the two classification CLIs on the CPU ----------------------------------

@pytest.fixture
def tiny_registries(monkeypatch):
    """A tiny ResNet and an 8x8 stand-in under the registries the CLIs
    resolve their flags through."""
    from uurg_torch.data.datasets import dataset_registry, synthetic_dataset
    from uurg_torch.models import model_registry
    from uurg_torch.models.resnet import BasicBlock, ResNet

    def tiny(num_classes=4, dtype=torch.float32):
        return ResNet([1, 1], BasicBlock, num_classes, width=8, dtype=dtype)

    def data(root, train=True):
        return synthetic_dataset(128 if train else 64, 8, 3, 4,
                                 seed=0 if train else 1, base_seed=0,
                                 noise_sigma=0.5)

    monkeypatch.setitem(model_registry._entries, "TinyResNet", tiny)
    monkeypatch.setitem(dataset_registry._entries, "TINY", data)


JAX_COLUMNS = ["method", "unlearn_time", "retain_acc", "forget_acc",
               "test_acc", "mia", "svc_confidence", "svc_entropy",
               "svc_m_entropy", "js_div"]


def test_classification_clis_on_cpu(tiny_registries, tmp_path):
    """main_pretrain writes ``<model>_best`` (parameters and BatchNorm
    buffers) and its JSON; main_random reads it, runs SFR-on (its 1500
    iterations) with the SVC attack and the JS divergence to a retrained
    file, writes the unlearned file and the CSV row under the JAX CLI's
    columns."""
    from uurg_torch.cli import main_pretrain, main_random
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.models.resnet import BasicBlock, ResNet

    common = ["--dataset", "TINY", "--model", "TinyResNet", "--num_classes",
              "4", "--batch_size", "32", "--device", "cpu"]
    pre = str(tmp_path / "pre")
    best = main_pretrain.main(common + ["--epochs", "2", "--save_path", pre])
    meta = json.load(open(os.path.join(pre, "TinyResNet_best.json")))
    assert meta["acc"] == best and meta["epoch"] in (0, 1)
    tree = restore_checkpoint(os.path.join(pre, "TinyResNet_best"),
                              like=ResNet([1, 1], BasicBlock, 4, width=8))
    assert int(tree["bn1.num_batches_tracked"]) > 0

    out = str(tmp_path / "out")
    ckpt = os.path.join(pre, "TinyResNet_best")
    res = main_random.main(common + [
        "--unlearn_method", "SFRon", "--svc_mia", "--checkpoint", ckpt,
        "--retrain_checkpoint", ckpt, "--save_path", out])
    rows = list(csv.DictReader(open(os.path.join(out, "results.csv"))))
    assert list(rows[0]) == JAX_COLUMNS
    assert rows[0]["method"] == "SFRon" and float(res["js_div"]) >= 0.0
    assert all(0.0 <= res[k] <= 100.0
               for k in ("retain_acc", "forget_acc", "test_acc"))
    assert all(0.0 <= res[k] <= 1.0 for k in JAX_COLUMNS[5:9])
    assert os.path.isfile(os.path.join(out, "SFRon_unlearned"))
    assert len(np.load(os.path.join(out, "random_idx.npy"))) == 12

    # incremental stages and the comparison protocol from the same file
    main_random.main(common + ["--unlearn_method", "Finetune",
                               "--incremental", "2", "--checkpoint", ckpt,
                               "--save_path", out])
    main_random.main(common + ["--compare", "Baseline,Finetune",
                               "--checkpoint", ckpt, "--forget_mode",
                               "class", "--save_path", str(tmp_path / "c")])
    rows = list(csv.DictReader(open(tmp_path / "c" / "results.csv")))
    assert [r["method"] for r in rows] == ["Baseline", "Finetune"]
    assert "test_forget_acc" in rows[0] and "svc_mia_entropy" in rows[0]


def test_classification_clis_need_the_card_unless_asked(tiny_registries,
                                                         tmp_path):
    from uurg_torch.cli import main_pretrain, main_random

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cli in (main_random, main_pretrain):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--dataset", "TINY", "--model", "TinyResNet",
                      "--save_path", str(tmp_path)])


def test_orbax_checkpoint_directory_raises(tiny_registries, tmp_path):
    from uurg_torch.cli import main_random

    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        main_random.main(["--dataset", "TINY", "--model", "TinyResNet",
                          "--num_classes", "4", "--device", "cpu",
                          "--checkpoint", str(tmp_path / "orbax"),
                          "--save_path", str(tmp_path / "o")])
