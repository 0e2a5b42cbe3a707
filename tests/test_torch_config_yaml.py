"""The port's own YAML reader and writer (``uurg_torch/core/config.py``,
``uurg_torch/core/expdir.py``) against PyYAML, which the JAX package reads
the same files with: every config of the repository, Hypothesis-drawn
documents as ``yaml.safe_dump`` writes them, the writer's output under both
readers, the refusals, no ``yaml`` import in the port, and the trainer CLI in
a process where ``import yaml`` fails."""
import ast
import glob
import math
import os
import subprocess
import sys

import pytest

yaml = pytest.importorskip("yaml")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from uurg_torch.core.config import (load_config, load_yaml,  # noqa: E402
                                    parse_yaml, resolve_plain)
from uurg_torch.core.expdir import dump_yaml  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


def _same(a, b) -> bool:
    """Equal values of equal types all the way down (``True == 1`` and
    ``1 == 1.0`` would hide a scalar resolved to the wrong type)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        def keys(d):
            return sorted((type(k).__name__, repr(k)) for k in d)

        return keys(a) == keys(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_seven_configs_are_found():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load_on_each_config(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = load_yaml(path)
    assert _same(got, want)
    assert load_config(path).to_dict() == want
    if path.endswith("cifar10_saliency_unlearn.yml"):
        # YAML 1.1: a float needs a dot, so this lr is a string on both sides
        assert got["optim"]["lr"] == want["optim"]["lr"] == "1e-05"


@pytest.mark.parametrize("text", [
    "1.0e-05", "1e-05", "1.e+5", "0x1F", "012", "08", "1_000", "1:30",
    "190:20:30.15", ".inf", "-.Inf", ".NaN", "yes", "No", "ON", "off", "y",
    "~", "null", "Null", "0b101", "+1.5", "-0", "0o17", "1e5", ".5", "abc"])
def test_plain_scalars_resolve_as_pyyaml_resolves_them(text):
    assert _same(parse_yaml(f"a: {text}\n")["a"], yaml.safe_load(
        f"a: {text}\n")["a"])


# the scalars and lists the configs use: short strings (no line folding in
# safe_dump's output) over characters that make PyYAML quote, and strings
# that would resolve as something else
_WORDS = ["1e-05", "true", "null", "012", "0x1F", "yes", "~", "1:30",
          ".inf", "", " a", "a: b", "it's", "#x", "- x", "[x]", "=", "<<",
          "2001-01-01", 'say "hi"', "a\\b", "./data", "CIFAR10"]
_TEXT = st.one_of(
    st.text(alphabet="abcXYZ019 ._-/:#'\"!&*,[]{}%@`|>?~=", max_size=10),
    st.sampled_from(_WORDS))
_SCALARS = st.one_of(st.none(), st.booleans(),
                     st.integers(-10 ** 12, 10 ** 12),
                     st.floats(allow_nan=False), _TEXT)
_VALUES = st.one_of(_SCALARS, st.lists(_SCALARS, max_size=4))
_KEYS = st.one_of(st.text(alphabet="abz_019", min_size=1, max_size=6),
                  st.sampled_from(["yes", "null", "1", "on", "x y"]))
_DOCS = st.recursive(
    st.dictionaries(_KEYS, _VALUES, max_size=4),
    lambda inner: st.dictionaries(_KEYS, st.one_of(_VALUES, inner),
                                  max_size=4),
    max_leaves=12)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_DOCS)
def test_reader_equals_safe_load_on_safe_dump(doc):
    text = yaml.safe_dump(doc)
    assert _same(parse_yaml(text), yaml.safe_load(text))
    # and in the flow style of leaf collections that configs use; PyYAML
    # wraps a long one over lines, which the reader refuses by name
    text = yaml.safe_dump(doc, default_flow_style=None)
    try:
        got = parse_yaml(text)
    except ValueError as err:
        assert "does not close on its line" in str(err)
        # the same document unwrapped reads back
        text = yaml.safe_dump(doc, default_flow_style=None, width=math.inf)
        assert _same(parse_yaml(text), yaml.safe_load(text))
    else:
        assert _same(got, yaml.safe_load(text))


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(_DOCS)
def test_writer_reads_back_under_both_readers(doc):
    text = dump_yaml(doc)
    assert _same(yaml.safe_load(text), doc)
    assert _same(parse_yaml(text), doc)


def test_writer_quotes_strings_that_resolve_as_something_else():
    doc = {"lr": "1e-05", "b": "true", "n": "null", "o": "012", "e": "",
           "f": 1e-05, "g": float("inf"), "h": [1, "x y", None],
           "nested": {"deep": {"on": "off"}}, "empty": {}}
    text = dump_yaml(doc)
    for word in ("1e-05", "true", "null", "012", "off"):
        assert f'"{word}"' in text
    assert "f: 1.0e-05" in text
    assert _same(yaml.safe_load(text), doc) and _same(parse_yaml(text), doc)
    # a plain string keeps its plain form
    assert resolve_plain("CIFAR10") == "str" and "CIFAR10" in dump_yaml(
        {"d": "CIFAR10"})
    with pytest.raises(TypeError, match="set"):
        dump_yaml({"s": {1, 2}})


@pytest.mark.parametrize("text,line,what", [
    ("a: 1\nb: &x 2\n", 2, "anchors"),
    ("a: 1\n\nb: *x\n", 3, "aliases"),
    ("a: !!int 1\n", 1, "tags"),
    ("a: 1\nb: |\n  x\n", 2, "block scalars"),
    ("a: >\n  x\n", 1, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "document markers"),
    ("a: 1\n# c\na: 2\n", 3, "duplicate key"),
    ("a:\n\tb: 1\n", 2, "tab"),
    ("a: [1,\n  2]\n", 1, "flow"),
    ("a: 'x\n  y'\n", 1, "quoted"),
    ("a: b: c\n", 1, "mapping value"),
    ("a: 2001-01-01\n", 1, "timestamp"),
    ("<<: {a: 1}\n", 1, "merge"),
    ("a:\n    b: 1\n  c: 2\n", 3, "indentation"),
    ("a: x\n  y\n", 2, "multi-line"),
    ("? a\n: 1\n", 1, "complex keys"),
    ('a: "\\q"\n', 1, "escape"),
])
def test_refusals_name_their_line(text, line, what):
    with pytest.raises(ValueError, match=what) as err:
        parse_yaml(text, "f.yml")
    assert str(err.value).startswith(f"f.yml:{line}:")


def _yaml_imports(path: str) -> list[int]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    lines = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        if any(n == "yaml" or n.startswith("yaml.") for n in names):
            lines.append(node.lineno)
    return lines


def test_no_yaml_import_in_the_port_or_chip_smoke():
    files = glob.glob(os.path.join(ROOT, "uurg_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 50
    found = {os.path.relpath(f, ROOT): _yaml_imports(f) for f in files}
    assert {f: n for f, n in found.items() if n} == {}


# the trainer CLI as a user runs it, in a process where importing yaml fails
_BLOCKED = """
import runpy, sys
sys.modules["yaml"] = None
sys.argv = ["uurg_torch.cli.train"] + sys.argv[1:]
runpy.run_module("uurg_torch.cli.train", run_name="__main__", alter_sys=True)
"""


def test_train_cli_runs_without_pyyaml(tmp_path):
    cfg = load_config(os.path.join(ROOT, "configs", "cifar10_sfron.yml"))
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1}
    train = {**cfg.training.to_dict(), "batch_size": 4, "snapshot_freq": 2,
             "log_freq": 1, "visualization_samples": 0}
    data = {**cfg.data.to_dict(), "path": str(tmp_path / "no_cifar"),
            "synthetic_n": 64}
    cfg = cfg.merged({"model": model, "training": train, "data": data,
                      "sampling": {"batch_size": 4}})
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--config", str(cfg_path),
         "--mode", "sfron", "--n_iters", "2", "--device", "cpu",
         "--exp", str(tmp_path / "exp")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    dumps = list((tmp_path / "exp").rglob("logs/config.yaml"))
    assert len(dumps) == 1 and list((tmp_path / "exp").rglob("ckpt.pth"))
    text = dumps[0].read_text()
    mine, pyyaml = parse_yaml(text), yaml.safe_load(text)
    assert _same(mine, pyyaml)
    assert mine["training"]["n_iters"] == 2 and mine["model"]["ch"] == 32
    assert mine["args"]["mode"] == "sfron"
    assert mine["args"]["threshold"] == [1.0]
    assert mine["ckpt_dir"].endswith("ckpts")
