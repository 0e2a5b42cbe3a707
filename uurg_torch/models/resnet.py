"""ResNets for the classifier probe: CIFAR stem or ImageNet stem, NCHW.

Port of ``uurg_tpu/models/resnet.py`` (parity target Classification/models/
resnet.py:107-124): a 3x3 conv stem without max pool, or with
``imagenet_stem`` the 7x7/s2 conv and a 3x3/s2 max pool (the UA probe, a
torchvision ResNet-34 at 224 px); BasicBlock for 18/34, Bottleneck (stride
on the 3x3) for 50/101/152; BatchNorm eps 1e-5, momentum 0.1 (the JAX
package's 0.9 in flax's convention); a global mean and a float32 fc.
Padding is torch's explicit padding, as the JAX model uses.

BatchNorm in train mode is flax's: it normalises with the batch statistics
and moves the running variance toward the *biased* batch variance, where
``nn.BatchNorm2d`` moves it toward the unbiased one (n / (n - 1) larger: 1.6%
at n = 64). Eval mode is ``nn.BatchNorm2d``'s own. :func:`init_classifier`
draws flax's initial weights.

Parameter names are torchvision's (``conv1``, ``bn1``, ``layer{1-4}.{j}.
conv1/bn1/conv2/bn2[/conv3/bn3]/downsample.{0,1}``, ``fc``), so a
torchvision checkpoint loads directly and a reference-CIFAR one through
:mod:`uurg_torch.io.tv_resnet_interop`. The convolutions compute in
``dtype`` (inputs and weights cast at each convolution, float32 weights
kept); BatchNorm, the residual sums, the mean and the fc run in float32,
as the JAX model's ``dtype=bfloat16`` does (in float64 when the model is
built with ``dtype=torch.float64`` and converted with ``.double()``, for
precision checks).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's ``nn.BatchNorm``:
    ``running = (1 - momentum) * running + momentum * batch`` with the
    biased batch variance. The names of its parameters and buffers are the
    stock layer's, ``num_batches_tracked`` included (counted, never read)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y

class Conv2d(nn.Conv2d):
    """Bias-free convolution computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride, padding, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for a model run in float64 (``.double()``)."""
    return x if x.dtype == torch.float64 else x.float()


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return bn(_wide(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, filters, 3, stride, 1, dtype)
        self.bn1 = _bn(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, dtype)
        self.bn2 = _bn(filters)
        self.downsample = None
        if cin != filters or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(cin, filters, 1, stride, 0, dtype), _bn(filters))

    def forward(self, x):
        h = F.relu(_norm(self.bn1, self.conv1(x)))
        h = _norm(self.bn2, self.conv2(h))
        if self.downsample is not None:
            x = _norm(self.downsample[1], self.downsample[0](x))
        return F.relu(x + h)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = Conv2d(cin, filters, 1, 1, 0, dtype)
        self.bn1 = _bn(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, dtype)
        self.bn2 = _bn(filters)
        self.conv3 = Conv2d(filters, out, 1, 1, 0, dtype)
        self.bn3 = _bn(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(cin, out, 1, stride, 0, dtype), _bn(out))

    def forward(self, x):
        h = F.relu(_norm(self.bn1, self.conv1(x)))
        h = F.relu(_norm(self.bn2, self.conv2(h)))
        h = _norm(self.bn3, self.conv3(h))
        if self.downsample is not None:
            x = _norm(self.downsample[1], self.downsample[0](x))
        return F.relu(x + h)


class ResNet(nn.Module):
    """NCHW float images -> float32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock,
                 num_classes: int = 10, width: int = 64,
                 dtype: torch.dtype = torch.float32,
                 imagenet_stem: bool = False):
        super().__init__()
        self.imagenet_stem = imagenet_stem
        self.conv1 = (Conv2d(3, width, 7, 2, 3, dtype) if imagenet_stem
                      else Conv2d(3, width, 3, 1, 1, dtype))
        self.bn1 = _bn(width)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, width * 2 ** i, stride, dtype))
                cin = width * 2 ** i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = F.relu(_norm(self.bn1, self.conv1(x)))
        if self.imagenet_stem:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(_wide(x).mean(dim=(2, 3)))


def ResNet18(num_classes=10, dtype=torch.float32, imagenet_stem=False):
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes, dtype=dtype,
                  imagenet_stem=imagenet_stem)


def ResNet34(num_classes=10, dtype=torch.float32, imagenet_stem=False):
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes, dtype=dtype,
                  imagenet_stem=imagenet_stem)


def ResNet50(num_classes=10, dtype=torch.float32, imagenet_stem=False):
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes, dtype=dtype,
                  imagenet_stem=imagenet_stem)


def ResNet101(num_classes=10, dtype=torch.float32, imagenet_stem=False):
    return ResNet([3, 4, 23, 3], Bottleneck, num_classes, dtype=dtype,
                  imagenet_stem=imagenet_stem)


def ResNet152(num_classes=10, dtype=torch.float32, imagenet_stem=False):
    return ResNet([3, 8, 36, 3], Bottleneck, num_classes, dtype=dtype,
                  imagenet_stem=imagenet_stem)


@torch.no_grad()
def init_classifier(generator: torch.Generator,
                    model: nn.Module) -> nn.Module:
    """flax's initial weights, in distribution, drawn from ``generator`` in
    place: LeCun-normal kernels of the convolutions and the dense layer (a
    normal of variance 1 / fan_in truncated at two standard deviations and
    rescaled, as ``variance_scaling(1, "fan_in", "truncated_normal")``),
    zero dense bias, BatchNorm scale 1, bias 0 and identity running
    statistics. Returns ``model``."""
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = (1.0 / mod.weight[0].numel()) ** 0.5 / trunc_std
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model
