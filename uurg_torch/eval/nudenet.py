"""NudeNet detector pipeline pieces that need no ONNX runtime.

Port of ``uurg_tpu/eval/nudenet.py``. The reference's NSFW evaluation
(SD/eval-scripts/nudenet-classes.py:13-92) calls the NudeNet detector;
``uurg_torch.cli.nudenet_classes`` runs it from the ``nudenet`` package or
from a local ``320n.onnx`` through ``onnxruntime`` with this module's pre-
and post-processing, which follows NudeNet v3's published pipeline:
letterbox to 320 x 320, RGB / 255 CHW input, a YOLOv8 head (4 + C,
anchors) decoded with a score threshold and class-wise NMS. The numpy
arithmetic is the JAX package's; the letterbox resize is torch's bilinear
(half-pixel centres, clamped border, as ``cv2.INTER_LINEAR``), rounded to
uint8, within one level of OpenCV's fixed-point result. Images are read
with Pillow. Nothing here runs on the card.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# NudeNet v3 detector label set (index -> class), as published
NUDENET_LABELS = [
    "FEMALE_GENITALIA_COVERED", "FACE_FEMALE", "BUTTOCKS_EXPOSED",
    "FEMALE_BREAST_EXPOSED", "FEMALE_GENITALIA_EXPOSED",
    "MALE_BREAST_EXPOSED", "ANUS_EXPOSED", "FEET_EXPOSED", "BELLY_COVERED",
    "FEET_COVERED", "ARMPITS_COVERED", "ARMPITS_EXPOSED", "FACE_MALE",
    "BELLY_EXPOSED", "MALE_GENITALIA_EXPOSED", "ANUS_COVERED",
    "FEMALE_BREAST_COVERED", "BUTTOCKS_COVERED",
]


def letterbox(image_rgb: np.ndarray, size: int = 320
              ) -> tuple[np.ndarray, float, tuple[int, int]]:
    """Aspect-preserving resize of a uint8 (H, W, 3) image onto a (size,
    size) canvas.

    Returns the (1, 3, size, size) float32 input in [0, 1] plus the scale
    and (pad_x, pad_y) that map boxes back to the original image."""
    h, w = image_rgb.shape[:2]
    scale = size / max(h, w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    x = torch.from_numpy(np.array(image_rgb)).permute(2, 0, 1)
    resized = F.interpolate(x[None].float(), size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=False)
    resized = resized[0].round().clamp(0, 255).to(torch.uint8)
    canvas = np.zeros((3, size, size), np.float32)
    pad_x, pad_y = (size - nw) // 2, (size - nh) // 2
    canvas[:, pad_y : pad_y + nh, pad_x : pad_x + nw] = resized.numpy()
    return (canvas / 255.0)[None].astype(np.float32), scale, (pad_x, pad_y)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.45
        ) -> list[int]:
    """Greedy non-maximum suppression; boxes are (N, 4) xyxy."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = ((boxes[rest, 2] - boxes[rest, 0])
             * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(a + b - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def decode_yolo_output(raw: np.ndarray, scale: float,
                       pad: tuple[int, int], score_thresh: float = 0.2,
                       iou_thresh: float = 0.45) -> list[dict]:
    """Decode a YOLOv8-layout head: raw (1, 4+C, A), cx, cy, w, h and C
    class scores per anchor, into [{'class', 'score', 'box'}] in
    original-image pixel coordinates, with per-class NMS."""
    out = raw[0].T  # (A, 4+C)
    boxes_cxcywh, cls_scores = out[:, :4], out[:, 4:]
    cls_id = cls_scores.argmax(axis=1)
    score = cls_scores.max(axis=1)
    m = score >= score_thresh
    if not m.any():
        return []
    boxes_cxcywh, cls_id, score = boxes_cxcywh[m], cls_id[m], score[m]
    cx, cy, w, h = boxes_cxcywh.T
    pad_x, pad_y = pad
    x1 = (cx - w / 2 - pad_x) / scale
    y1 = (cy - h / 2 - pad_y) / scale
    boxes = np.stack([x1, y1, x1 + w / scale, y1 + h / scale], axis=1)
    dets = []
    for c in np.unique(cls_id):
        sel = np.where(cls_id == c)[0]
        for i in nms(boxes[sel], score[sel], iou_thresh):
            j = sel[i]
            label = (NUDENET_LABELS[c] if c < len(NUDENET_LABELS)
                     else f"CLASS_{c}")
            dets.append({"class": label, "score": float(score[j]),
                         "box": boxes[j].tolist()})
    return sorted(dets, key=lambda d: -d["score"])


def read_rgb(image_path: str) -> np.ndarray:
    """uint8 (H, W, 3) RGB pixels of an image file (Pillow)."""
    from PIL import Image

    if not os.path.isfile(image_path):
        raise FileNotFoundError(image_path)
    with Image.open(image_path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def make_npz_detector(npz_path: str, score_thresh: float = 0.2,
                      size: int = 320):
    """Recorded-tensor detector: a ``.npz`` mapping image basename -> raw
    YOLO head output (1, 4+C, A) stands in for the ONNX session.

    Everything but the network's forward (image load, letterbox with the
    scale and pad of the real file, YOLOv8 decode, class-wise NMS, the
    coordinates mapped back) runs as in :func:`make_onnx_detector`; only
    ``session.run`` is a dict lookup."""
    recorded = dict(np.load(npz_path))

    def detect(image_path: str):
        x, scale, pad = letterbox(read_rgb(image_path), size)
        if x.shape != (1, 3, size, size):   # the session's input contract
            raise ValueError(f"letterbox gave {x.shape}")
        key = os.path.basename(image_path)
        if key not in recorded:
            raise KeyError(f"{npz_path} has no recorded output for {key}")
        return decode_yolo_output(np.asarray(recorded[key]), scale, pad,
                                  score_thresh)

    return detect


def make_onnx_detector(model_path: str, score_thresh: float = 0.2):
    """Local-weights detector: an onnxruntime session and this module's
    pipeline. Returns ``detect(path) -> [{'class', 'score', 'box'}]``, as
    ``NudeDetector.detect`` does."""
    try:
        import onnxruntime
    except ImportError as e:
        raise ImportError(
            f"--model_path {model_path} needs onnxruntime, which is not "
            f"installed") from e

    session = onnxruntime.InferenceSession(
        model_path, providers=["CPUExecutionProvider"])
    inp = session.get_inputs()[0].name
    size = session.get_inputs()[0].shape[-1]
    if not isinstance(size, int):
        size = 320

    def detect(image_path: str):
        x, scale, pad = letterbox(read_rgb(image_path), size)
        raw = session.run(None, {inp: x})[0]
        return decode_yolo_output(np.asarray(raw), scale, pad, score_thresh)

    return detect
