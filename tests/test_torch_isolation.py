"""uurg_torch and chip_smoke.py never import JAX, the JAX package or
scikit-learn (the card's machine has none)."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "uurg_tpu", "sklearn")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "uurg_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_importing_the_port_loads_no_jax():
    # a fresh interpreter: this test process already imported jax (conftest)
    code = (
        "import importlib, pkgutil, sys\n"
        "import uurg_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(uurg_torch.__path__, "
        "'uurg_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_import_in_port_sources():
    found = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [(path, n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 20
    assert not found, found


def test_every_kernel_source_is_bound_by_a_port_module():
    # each csrc/*.cu is built and bound by a module of uurg_torch/ops (which
    # the two tests above hold to importing no JAX), by its stem
    csrc = os.path.join(ROOT, "uurg_torch", "csrc")
    ops = [p for p in _port_files()
           if os.sep + os.path.join("uurg_torch", "ops") + os.sep in p]
    text = "".join(open(p).read() for p in ops)
    stems = sorted(n[:-3] for n in os.listdir(csrc) if n.endswith(".cu"))
    assert "flash_attention_xwide_bwd" in stems
    assert [s for s in stems if f'"{s}"' not in text] == []


def test_chip_smoke_refuses_to_run_outside_a_checkout(tmp_path):
    # the script alone in a directory: non-zero exit, no result line
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# the Stable Diffusion slice: each module is among the files both tests
# above read and import
SD_MODULES = ("models/sd_unet", "models/clip_text", "workloads/sd",
              "workloads/sd_runner", "io/sd_interop", "io/vae_clip_interop",
              "cli/sd_common", "cli/sd_generate_fisher",
              # its methods, their CLIs, the Diffusers export and the data
              "io/diffusers_interop", "data/sd_data", "cli/nsfw_removal",
              "cli/train_esd", "cli/gradient_ascent",
              "cli/proximal_gradient", "cli/random_label",
              "cli/generate_fisher_mask",
              # its evaluation
              "eval/nudenet", "cli/generate_images", "cli/imageclassify",
              "cli/nudenet_classes", "cli/compute_fid")


@pytest.mark.parametrize("module", SD_MODULES)
def test_sd_modules_are_covered(module):
    path = os.path.join(ROOT, "uurg_torch", *module.split("/")) + ".py"
    assert path in _port_files()
    tree = ast.parse(open(path).read(), path)
    imported = [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in imported if m.split(".")[0] in FORBIDDEN]


SD_EVAL = ("uurg_torch.eval.nudenet", "uurg_torch.cli.generate_images",
           "uurg_torch.cli.imageclassify", "uurg_torch.cli.nudenet_classes",
           "uurg_torch.cli.compute_fid")


def test_sd_evaluation_runs_without_cv2_and_pandas(tmp_path):
    """The evaluation modules import, letterbox an image and read a prompt
    CSV with ``cv2`` and ``pandas`` blocked (the card's machine may lack
    both), loading nothing of JAX."""
    csv_path = tmp_path / "p.csv"
    csv_path.write_text('case_number,prompt\n0,"a, b"\n')
    code = (
        "import importlib, sys\n"
        "sys.modules['cv2'] = sys.modules['pandas'] = None\n"
        f"for m in {SD_EVAL!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from uurg_torch.eval.nudenet import letterbox\n"
        "from uurg_torch.cli.generate_images import read_prompts\n"
        "x, scale, pad = letterbox(np.zeros((10, 20, 3), np.uint8), 32)\n"
        "assert x.shape == (1, 3, 32, 32) and pad == (0, 8), pad\n"
        f"assert read_prompts({str(csv_path)!r}) == [(0, 'a, b', 42)]\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
