"""InceptionV3 (FID variant): the FID/IS feature extractor.

Port of ``uurg_tpu/eval/inception.py``, NCHW and float32. It emits the
three tensors the ADM suite reads (DDPM/evaluator.py:32-36): pool3 (2048-d),
early spatial features (the first 7 channels of the mixed_6 tower output,
17x17x7 = 2023-d, flattened in NHWC order as the JAX package flattens them)
and 1008-way logits.

This is the *FID* inception, not torchvision's: the branch average pools
leave the padding out of their divisor (``count_include_pad=False``),
Mixed_7c's pool branch is a MAX pool (the TF graph's quirk, kept by
pytorch-fid's FIDInceptionE_2), BatchNorm runs on its running statistics
with eps 1e-3, and the fc head is 1008-way. Submodule names follow
pytorch-fid's ``pt_inception`` (torchvision's layout), so
``pt_inception-2015-12-05.pth`` loads through :func:`load_inception_pth`;
the JAX package's flax-layout npz loads through :func:`load_inception_npz`.
Convolutions, pools and the fc go to cuDNN and cuBLAS: the JAX package has
no Pallas kernel here either.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uurg_torch.core.rng import seeded_init_
from uurg_torch.utils.images import resize_bilinear


class BasicConv2d(nn.Module):
    """Conv (no bias) -> BatchNorm on running statistics (eps 1e-3) ->
    ReLU. Stride-1 convolutions pad to keep the size (XLA "SAME" for odd
    kernels) unless ``valid``."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 valid: bool = False):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        pad = (0, 0) if valid or stride > 1 else (kh // 2, kw // 2)
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride, pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool_exc(x):
    """3x3 stride-1 average pool whose divisor counts only the cells inside
    the image (TF semantics)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x),
                          self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avg_pool_exc(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        d = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), d, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        d = x
        for i in range(1, 6):
            d = getattr(self, f"branch7x7dbl_{i}")(d)
        return torch.cat([self.branch1x1(x), b7, d,
                          self.branch_pool(_avg_pool_exc(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """Mixed_7b pools by the padding-excluded average, Mixed_7c by max."""

    def __init__(self, cin: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        d = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        pool = (F.max_pool2d(x, 3, 1, 1) if self.max_pool
                else _avg_pool_exc(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(d), self.branch3x3dbl_3b(d),
            self.branch_pool(pool)], 1)


class InceptionV3(nn.Module):
    """NCHW float images in [-1, 1] at 299 px -> (pool3 (B, 2048), spatial
    (B, 2023), logits (B, 1008))."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, valid=True)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, valid=True)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        # sFID: the first 7 channels of the mixed_6 output, flattened as
        # (H, W, 7) like the JAX package's NHWC slice
        spatial = x[:, :7].permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool = x.mean(dim=(2, 3))
        return pool, spatial, self.fc(pool)


def preprocess(images_uint8: torch.Tensor, size: int = 299) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, bilinear resize to ``size`` (as
    ``jax.image.resize``) -> scaled to [-1, 1]."""
    x = images_uint8.permute(0, 3, 1, 2).float()
    return resize_bilinear(x, size) / 127.5 - 1.0


def make_extractor(model: InceptionV3, materialize: bool = True):
    """Callable: uint8 NHWC numpy images -> (pool, spatial, logits), run on
    the model's device.

    ``materialize=True`` returns numpy (waiting for the device).
    ``materialize=False`` returns device tensors, so that
    :func:`uurg_torch.eval.generative.featurize` copies batch i to the host
    while the device computes batch i+1."""
    device = next(model.parameters()).device
    model.eval()

    def extract(images_uint8: np.ndarray):
        # from pageable memory the copy is staged before the call returns,
        # so non_blocking waits for nothing queued before it
        x = torch.from_numpy(np.ascontiguousarray(images_uint8)).to(
            device, non_blocking=True)
        with torch.inference_mode():
            out = model(preprocess(x))
        if not materialize:
            return out
        return tuple(o.cpu().numpy() for o in out)

    return extract


def init_inception(seed: int = 0) -> InceptionV3:
    """A seeded random InceptionV3 on the CPU, for runs without the
    published weights: He-normal convolutions (``core.rng.seeded_init_``),
    so that features and logits keep their scale through its 94 conv and
    ReLU layers (with LeCun's variance they shrink by 2**-47 and FID reads
    rounding noise)."""
    return seeded_init_(InceptionV3(), seed, conv_gain=2.0)


def load_inception_npz(path: str) -> InceptionV3:
    """The JAX package's flat flax-layout npz ('params/Mixed_5b/b1x1/conv/
    kernel', ...; ``cli/convert_inception.py`` writes it) -> InceptionV3 on
    the CPU."""
    from uurg_torch.io.inception_interop import flax_inception_to_torch

    flat = np.load(path)
    model = InceptionV3()
    model.load_state_dict(flax_inception_to_torch(
        {k: flat[k] for k in flat.files}), strict=True)
    return model.eval()


def load_inception_pth(path: str) -> InceptionV3:
    """pytorch-fid's ``pt_inception-2015-12-05.pth`` (or any state dict in
    its layout) -> InceptionV3 on the CPU. ``AuxLogits.*`` and
    ``num_batches_tracked`` are dropped; any other key the model does not
    have raises."""
    from uurg_torch.io.inception_interop import pt_inception_state_dict

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = InceptionV3()
    model.load_state_dict(pt_inception_state_dict(sd), strict=True)
    return model.eval()


def load_inception(path: str) -> InceptionV3:
    """InceptionV3 on the CPU from ``path``, by suffix: the JAX package's
    ``.npz`` (:func:`load_inception_npz`) or a pytorch-fid ``.pth``
    (:func:`load_inception_pth`); the seeded random init, with a warning,
    when ``path`` is empty."""
    if not path:
        logging.warning("no InceptionV3 weights given: a seeded random "
                        "init, NOT comparable to published FID numbers")
        return init_inception(0)
    if path.endswith(".npz"):
        return load_inception_npz(path)
    if path.endswith(".pth"):
        return load_inception_pth(path)
    raise ValueError(f"InceptionV3 weights {path}: expected an .npz (the "
                     f"JAX package's layout) or a pytorch-fid .pth")
