"""The port's NudeNet pipeline and ``nudenet_classes`` CLI against the JAX
package's (CPU):

- ``letterbox`` (torch's bilinear, rounded to uint8) against the JAX one
  (``cv2.resize`` INTER_LINEAR) at square, wide and tall images, up- and
  downscaled: scale and pad equal, pixels within one level (1/255);
- ``nms`` keep lists equal on seeded boxes whose scores tie;
- ``decode_yolo_output`` equal on seeded heads (boxes within 1e-5);
- the golden fixture of ``tests/test_nudenet.py`` (recorded YOLO heads on
  real PNG files) through both CLIs: equal CSVs;
- the onnxruntime and nudenet tiers without their packages."""
import csv
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from uurg_torch.cli import nudenet_classes as TCLI  # noqa: E402
from uurg_torch.eval import nudenet as TN  # noqa: E402
from uurg_tpu.eval import nudenet as JN  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# OpenCV's INTER_LINEAR on uint8 interpolates in 11-bit fixed point and
# rounds once; the port interpolates in float32 and rounds once
LEVEL = 1.0 / 255.0
BOX_ATOL = 1e-5
C = len(JN.NUDENET_LABELS)


def _image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth gradient plus noise: both interpolate between neighbours
    that differ, so a wrong source index shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     (xx + yy) * 127.0 / max(h + w - 2, 1)], -1)
    noise = rng.integers(-40, 41, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w,size", [
    (48, 48, 320),      # square, up
    (640, 640, 320),    # square, exactly half (OpenCV takes INTER_AREA)
    (512, 512, 320),    # the generated images: scale 0.625, no pad
    (100, 200, 320),    # wide, up
    (700, 1000, 320),   # wide, down
    (300, 77, 320),     # tall, up
    (901, 333, 320),    # tall, down
    (37, 53, 64),       # odd sizes
])
def test_letterbox_matches_jax(h, w, size):
    img = _image(h, w, h * w)
    got, g_scale, g_pad = TN.letterbox(img, size)
    want, w_scale, w_pad = JN.letterbox(img, size)
    assert got.dtype == np.float32 and got.shape == (1, 3, size, size)
    assert g_scale == w_scale and g_pad == w_pad
    diff = np.abs(got - want).max()
    assert diff <= LEVEL + 1e-7, diff * 255


def test_letterbox_largest_difference_is_one_level():
    """Over many seeded downscales the port differs from OpenCV by at most
    one level, in few pixels (the measured rate is printed)."""
    worst, share = 0.0, []
    for seed in range(6):
        img = np.random.default_rng(seed).integers(
            0, 256, (413 + seed, 517 - seed, 3), np.uint8)
        got = TN.letterbox(img, 320)[0]
        want = JN.letterbox(img, 320)[0]
        d = np.abs(got - want) * 255
        worst = max(worst, float(d.max()))
        share.append(float((d > 0.5).mean()))
    print(f"largest difference {worst:.3f} levels; pixels off by one: "
          f"{max(share):.4%} at most")
    assert worst <= 1 + 1e-4


def test_nms_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    for trial in range(20):
        n = int(rng.integers(1, 40))
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(5, 40, (n, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
        for iou in (0.3, 0.45, 0.7):
            assert TN.nms(boxes, scores, iou) == JN.nms(boxes, scores, iou)


@pytest.mark.parametrize("seed", range(4))
def test_decode_yolo_output_matches_jax(seed):
    rng = np.random.default_rng(seed)
    A = 2100
    raw = np.zeros((1, 4 + C, A), np.float32)
    raw[0, :2] = rng.uniform(0, 320, (2, A))
    raw[0, 2:4] = rng.uniform(4, 80, (2, A))
    raw[0, 4:] = rng.uniform(0, 0.3, (C, A)) ** 2 * 9
    scale, pad = (0.625, (0, 0)) if seed % 2 else (5.0, (0, 40))
    got = TN.decode_yolo_output(raw, scale, pad)
    want = JN.decode_yolo_output(raw, scale, pad)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["class"] == w["class"] and g["score"] == w["score"]
        np.testing.assert_allclose(g["box"], w["box"], rtol=0,
                                   atol=BOX_ATOL)


def _anchor(cx, cy, w, h, cls, score):
    col = np.zeros(4 + C, np.float32)
    col[:4] = (cx, cy, w, h)
    col[4 + cls] = score
    return col


@pytest.fixture
def golden(tmp_path):
    """tests/test_nudenet.py's fixture: two PNGs and their recorded heads
    (image A 64 x 48: scale 5, pad (0, 40); image B 40 x 40: scale 8)."""
    rng = np.random.default_rng(0)
    folder = tmp_path / "imgs"
    folder.mkdir()
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)).save(
        folder / "a.png")
    Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
        folder / "b.png")
    (folder / "notes.txt").write_text("not an image")
    raw_a = np.stack([
        _anchor(80, 120, 80, 80, 3, 0.9),
        _anchor(82, 122, 80, 80, 3, 0.8),      # NMS-suppressed duplicate
        _anchor(240, 200, 40, 40, 12, 0.5),
        _anchor(100, 100, 20, 20, 7, 0.1),     # under the score threshold
    ], axis=1)[None]
    raw_b = np.stack([_anchor(160, 160, 30, 30, 5, 0.15)], axis=1)[None]
    npz = tmp_path / "recorded.npz"
    np.savez(npz, **{"a.png": raw_a, "b.png": raw_b})
    return folder, npz


def test_npz_detector_maps_boxes_back(golden):
    folder, npz = golden
    detect = TN.make_npz_detector(str(npz))
    dets = detect(str(folder / "a.png"))
    assert [d["class"] for d in dets] == [TN.NUDENET_LABELS[3],
                                          TN.NUDENET_LABELS[12]]
    np.testing.assert_allclose(dets[0]["box"], [8, 8, 24, 24], atol=1e-3)
    assert dets == JN.make_npz_detector(str(npz))(str(folder / "a.png"))
    assert detect(str(folder / "b.png")) == []
    with pytest.raises(FileNotFoundError):
        detect(str(folder / "missing.png"))


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("threshold", ["0.0", "0.4", "0.6"])
def test_cli_matches_jax_on_the_golden_fixture(golden, tmp_path, monkeypatch,
                                               threshold):
    folder, npz = golden
    flags = ["--folder", str(folder), "--model_path", str(npz),
             "--threshold", threshold]
    monkeypatch.setattr(sys, "argv", ["nudenet_classes.py", *flags,
                                      "--save_path", str(tmp_path / "j.csv")])
    _jax_cli("nudenet_classes").main()
    TCLI.main([*flags, "--save_path", str(tmp_path / "t.csv")])
    got, want = _rows(tmp_path / "t.csv"), _rows(tmp_path / "j.csv")
    assert got == want
    assert [r["image"] for r in got] == ["a.png", "b.png"]
    assert open(tmp_path / "t.csv").read() == open(tmp_path / "j.csv").read()


def test_onnx_tier_names_onnxruntime(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    with pytest.raises(ImportError, match="onnxruntime"):
        TN.make_onnx_detector(str(tmp_path / "320n.onnx"))


def test_package_tier_exits_without_nudenet(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "nudenet", None)
    with pytest.raises(SystemExit, match="nudenet is not installed"):
        TCLI.main(["--folder", str(tmp_path), "--save_path",
                   str(tmp_path / "out.csv")])
