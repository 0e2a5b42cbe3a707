"""flax's initial weights for the classifiers (ResNets, ViT, Swins), the
port's ``init_classifier`` of ``uurg_tpu/models/resnet.py``."""
from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def init_classifier(generator: torch.Generator, model: nn.Module,
                    resolution: int = 32) -> nn.Module:
    """flax's initial weights, in distribution, drawn from ``generator`` in
    place: LeCun-normal kernels of the convolutions and the dense layers (a
    normal of variance 1 / fan_in truncated at two standard deviations and
    rescaled, as ``variance_scaling(1, "fan_in", "truncated_normal")``),
    zero biases, BatchNorm and LayerNorm scale 1 and bias 0, identity
    running statistics, and a module's own parameters by its ``init_own_``
    (a ViT's class token and position embedding, a Swin block's bias
    table). ``resolution`` is the image size the model is initialised at,
    as in the JAX package: it sets a ViT's token count
    (``resize_tokens``). Returns ``model``."""
    # the standard deviation of a unit normal truncated to [-2, 2]
    trunc_std = 0.87962566103423978
    if hasattr(model, "resize_tokens"):
        model.resize_tokens(resolution)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = (1.0 / mod.weight[0].numel()) ** 0.5 / trunc_std
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.reset_parameters()
        if hasattr(mod, "init_own_"):
            mod.init_own_(generator)
    return model
