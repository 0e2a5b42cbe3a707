"""Weights across from the JAX package and the reference checkpoints.

``jax_unet_params_to_torch`` is this package's own copy of the Flax ->
reference-name mapping of ``uurg_tpu/io/torch_interop.py``
(``flax_unet_params_to_torch``): Dense kernels are transposed (and become
1x1 conv weights inside attention blocks), HWIO conv kernels become OIHW.
It takes a nested dict of numpy arrays, so no JAX is needed to call it.
``jax_resnet_variables_to_torch`` does the same for the JAX package's
ResNet (``params`` and ``batch_stats``) under torchvision's names, and
``jax_vit_params_to_torch`` / ``jax_swin_params_to_torch`` for its ViT and
Swin, whose port keeps the Flax module names, and ``jax_dit_params_to_torch``
for its DiT under facebookresearch DiT's names (the inverse of
``uurg_tpu/io/dit_interop.py::torch_dit_state_to_flax``), and
``jax_vae_params_to_torch`` for its AutoencoderKL under the CompVis names,
and ``jax_sd_unet_params_to_torch`` / ``jax_clip_text_params_to_torch`` for
its SD UNet and CLIP text encoder, whose port keeps the Flax module names.

A JAX run's Orbax checkpoint cannot be read without JAX; export it first
with ``cli/export_torch.py`` to the reference ``ckpt.pth`` list format,
which :func:`load_reference_checkpoint` reads. The port's trainer writes
the same format (:func:`save_reference_checkpoint`), optimizer state
included, so a model it unlearned samples through the sampling CLI and a
run resumes from the file (:func:`load_training_checkpoint`).
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK_INNER = {
    ("norm1", "GroupNorm_0", "scale"): "norm1.weight",
    ("norm1", "GroupNorm_0", "bias"): "norm1.bias",
    ("norm2", "GroupNorm_0", "scale"): "norm2.weight",
    ("norm2", "GroupNorm_0", "bias"): "norm2.bias",
    ("conv1", "kernel"): "conv1.weight",
    ("conv1", "bias"): "conv1.bias",
    ("conv2", "kernel"): "conv2.weight",
    ("conv2", "bias"): "conv2.bias",
    ("emb_proj", "kernel"): "temb_cemb_proj.weight",
    ("emb_proj", "bias"): "temb_cemb_proj.bias",
    ("shortcut", "kernel"): "nin_shortcut.weight",
    ("shortcut", "bias"): "nin_shortcut.bias",
}

_ATTN_INNER = {
    ("norm", "GroupNorm_0", "scale"): "norm.weight",
    ("norm", "GroupNorm_0", "bias"): "norm.bias",
    **{(n, p): f"{n}.{'weight' if p == 'kernel' else 'bias'}"
       for n in ("q", "k", "v", "proj_out") for p in ("kernel", "bias")},
}


def _flatten(tree: Mapping, prefix=()) -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _kernel_to_torch(v: np.ndarray, *, attn: bool) -> np.ndarray:
    if attn and v.ndim == 2:
        return v.T[:, :, None, None]        # Dense -> 1x1 conv
    if v.ndim == 4:
        return v.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    if v.ndim == 2:
        return v.T                          # Dense -> Linear
    return v


def _param_name(rest: tuple) -> str:
    return "weight" if rest[-1] in ("kernel", "scale") else "bias"


def jax_unet_params_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """CondUNet Flax params (nested dict of arrays) -> state dict of
    float32 tensors under the reference torch names."""
    out = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        head, rest = path[0], path[1:]
        if head.startswith(("temb_dense", "cemb_dense")):
            tk = f"{head[:4]}.dense.{head[-1]}.{_param_name(rest)}"
            v = _kernel_to_torch(v, attn=False)
        elif head == "classes_emb":
            tk = "classes_emb.weight"
        elif head == "null_classes_emb":
            tk = "null_classes_emb"
        elif head in ("conv_in", "conv_out", "norm_out"):
            tk = f"{head}.{_param_name(rest)}"
            v = _kernel_to_torch(v, attn=False)
        elif (m := re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", head)):
            attn = m.group(3) == "attn"
            inner = (_ATTN_INNER if attn else _BLOCK_INNER)[rest]
            tk = f"{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}.{inner}"
            v = _kernel_to_torch(v, attn=attn)
        elif (m := re.fullmatch(r"(down|up)_(\d+)_(down|up)sample", head)):
            tk = (f"{m.group(1)}.{m.group(2)}.{m.group(3)}sample.conv."
                  f"{_param_name(rest)}")
            v = _kernel_to_torch(v, attn=False)
        elif (m := re.fullmatch(r"mid_(block_1|attn_1|block_2)", head)):
            attn = m.group(1) == "attn_1"
            inner = (_ATTN_INNER if attn else _BLOCK_INNER)[rest]
            tk = f"mid.{m.group(1)}.{inner}"
            v = _kernel_to_torch(v, attn=attn)
        else:
            raise KeyError(f"Unmapped flax path: {path}")
        out[tk] = torch.tensor(v)
    return out


_RESNET_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def jax_resnet_variables_to_torch(params: Mapping[str, Any],
                                  batch_stats: Mapping[str, Any]
                                  ) -> dict[str, torch.Tensor]:
    """The JAX package's ResNet variables (``uurg_tpu/models/resnet.py``:
    ``conv_stem``, ``bn_stem``, ``stage{i}_block{j}/{conv,bn}{k}``,
    ``sc_conv``, ``sc_bn``, ``fc``) -> a state dict of float32 tensors
    under the port's torchvision names (HWIO kernels to OIHW, the Dense
    kernel transposed, BatchNorm scale/bias/mean/var)."""
    out = {}
    for tree in (params, batch_stats):
        for path, v in _flatten(tree).items():
            v = np.asarray(v, np.float32)
            *mods, leaf = path
            if mods == ["fc"]:
                out[f"fc.{'weight' if leaf == 'kernel' else 'bias'}"] = \
                    torch.tensor(v.T if leaf == "kernel" else v)
                continue
            if mods[0] in ("conv_stem", "bn_stem"):
                name = mods[0].replace("_stem", "1")
            elif (m := re.fullmatch(r"stage(\d+)_block(\d+)", mods[0])):
                inner = {"sc_conv": "downsample.0",
                         "sc_bn": "downsample.1"}.get(mods[1], mods[1])
                name = f"layer{int(m.group(1)) + 1}.{m.group(2)}.{inner}"
            else:
                raise KeyError(f"Unmapped flax path: {path}")
            if leaf == "kernel":
                out[f"{name}.weight"] = torch.tensor(v.transpose(3, 2, 0, 1))
            else:
                out[f"{name}.{_RESNET_BN[leaf]}"] = torch.tensor(v)
    return out


def _flax_names_to_torch(params: Mapping[str, Any]
                         ) -> dict[str, torch.Tensor]:
    """Flax params -> a state dict under the same module path: Dense kernels
    (in, out) -> Linear weights (out, in), HWIO conv kernels -> OIHW,
    LayerNorm ``scale`` -> ``weight``; biases and bare parameters as they
    are."""
    out = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        *mods, leaf = path
        if leaf == "kernel":
            leaf, v = "weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                 else v.T)
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*mods, leaf])] = torch.tensor(v)
    return out


def jax_vit_params_to_torch(params: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """The JAX package's ViT params (``uurg_tpu/models/vit.py``) -> a state
    dict of :class:`uurg_torch.models.vit.ViT`: ``cls_token`` and
    ``pos_embed`` as they are, the rest as :func:`_flax_names_to_torch`."""
    return _flax_names_to_torch(params)


def jax_swin_params_to_torch(params: Mapping[str, Any]
                             ) -> dict[str, torch.Tensor]:
    """The JAX package's Swin params (``uurg_tpu/models/swin.py``) -> a
    state dict of :class:`uurg_torch.models.swin.Swin`: ``rel_pos_bias`` as
    it is, the rest as :func:`_flax_names_to_torch`."""
    return _flax_names_to_torch(params)


# the JAX DiT's module names -> the reference DiT's (DiT/models.py)
_DIT_TOP = {"patch_embed": "x_embedder.proj", "t_mlp1": "t_embedder.mlp.0",
            "t_mlp2": "t_embedder.mlp.2",
            "final_adaLN": "final_layer.adaLN_modulation.1",
            "final_linear": "final_layer.linear"}
_DIT_BLOCK = {("adaLN_modulation",): "adaLN_modulation.1",
              ("attn", "qkv"): "attn.qkv", ("attn", "proj"): "attn.proj",
              ("mlp_fc1",): "mlp.fc1", ("mlp_fc2",): "mlp.fc2"}


def _dit_leaf(name: str, leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        return f"{name}.weight", (v.transpose(3, 2, 0, 1) if v.ndim == 4
                                  else v.T)
    return f"{name}.{leaf}", v


def jax_dit_params_to_torch(params: Mapping[str, Any],
                            depth: int | None = None
                            ) -> dict[str, torch.Tensor]:
    """The JAX package's DiT params (``uurg_tpu/models/dit.py``), as nested
    dicts of arrays, -> a state dict of :class:`uurg_torch.models.dit.DiT`
    under the reference names. Reads both block layouts: one subtree a
    block (``block_{i}``, ``scan_blocks=False``) and the depth-stacked
    ``blocks`` of ``nn.scan`` (leading axis = block index). Dense kernels
    are transposed, the patch convolution goes HWIO -> OIHW. ``depth``, when
    given, must be the number of blocks found."""
    out: dict[str, np.ndarray] = {}
    n_blocks = 0
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        head, *rest = path
        if head in _DIT_TOP and len(rest) == 1:
            key, val = _dit_leaf(_DIT_TOP[head], rest[0], v)
            out[key] = val
        elif head == "y_embed" and rest == ["embedding"]:
            out["y_embedder.embedding_table.weight"] = v
        elif head == "blocks" or re.fullmatch(r"block_\d+", head):
            inner = _DIT_BLOCK.get(tuple(rest[:-1]))
            if inner is None:
                raise KeyError(f"Unmapped flax DiT path: {path}")
            if head == "blocks":
                slices = list(enumerate(v))
            else:
                slices = [(int(head.removeprefix("block_")), v)]
            for i, vi in slices:
                key, val = _dit_leaf(f"blocks.{i}.{inner}", rest[-1], vi)
                out[key] = val
                n_blocks = max(n_blocks, i + 1)
        else:
            raise KeyError(f"Unmapped flax DiT path: {path}")
    if depth is not None and n_blocks != depth:
        raise ValueError(f"found {n_blocks} DiT blocks, expected {depth}")
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def _vae_module(side: str, head: str) -> tuple[str, bool]:
    """The port's (CompVis) module name of a JAX AutoencoderKL submodule,
    and whether it is the attention block."""
    if head in ("conv_in", "conv_out", "norm_out"):
        return f"{side}.{head}", False
    if head == "mid_attn":
        return f"{side}.mid.attn_1", True
    if (m := re.fullmatch(r"mid_res_(\d)", head)):
        return f"{side}.mid.block_{m.group(1)}", False
    if (m := re.fullmatch(r"(down|up)_(\d+)_res_(\d+)", head)):
        return f"{side}.{m.group(1)}.{m.group(2)}.block.{m.group(3)}", False
    if (m := re.fullmatch(r"(down|up)_(\d+)_(down|up)sample", head)):
        return f"{side}.{m.group(1)}.{m.group(2)}.{m.group(3)}sample.conv", \
            False
    raise KeyError(f"Unmapped flax VAE module: {side}/{head}")


def jax_vae_params_to_torch(params: Mapping[str, Any]
                            ) -> dict[str, torch.Tensor]:
    """The JAX package's AutoencoderKL params
    (``uurg_tpu/models/autoencoder_kl.py``), as nested dicts of arrays, -> a
    state dict of :class:`uurg_torch.models.autoencoder_kl.AutoencoderKL`
    under the CompVis names. Conv kernels go HWIO -> OIHW, the attention's
    Dense kernels become 1x1 conv weights, GroupNorm scales become
    weights."""
    out = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        head, rest = path[0], path[1:]
        if head in ("quant_conv", "post_quant_conv") and len(rest) == 1:
            tk, attn, inner = head, False, rest
        elif head in ("encoder", "decoder"):
            tk, attn = _vae_module(head, rest[0])
            inner = rest[1:]
        else:
            raise KeyError(f"Unmapped flax VAE path: {path}")
        if attn:
            tk = f"{tk}.{_ATTN_INNER[inner]}"
        elif len(inner) == 1:
            tk = f"{tk}.{_param_name(inner)}"
        elif inner[0] in ("norm1", "norm2", "conv1", "conv2", "shortcut"):
            tk = f"{tk}.{_BLOCK_INNER[inner]}"
        elif inner[:1] == ("GroupNorm_0",):             # norm_out
            tk = f"{tk}.{_param_name(inner)}"
        else:
            raise KeyError(f"Unmapped flax VAE path: {path}")
        out[tk] = torch.tensor(np.ascontiguousarray(
            _kernel_to_torch(v, attn=attn)))
    return out


def sd_unet_torch_name(path: tuple) -> str:
    """The port's parameter name of a Flax SD UNet parameter path: the
    modules '.'-joined without the GroupNorm shim's ``GroupNorm_0``,
    ``kernel`` and ``scale`` become ``weight``."""
    *mods, leaf = path
    leaf = "weight" if leaf in ("kernel", "scale") else leaf
    return ".".join([*(m for m in mods if m != "GroupNorm_0"), leaf])


def jax_sd_unet_params_to_torch(params: Mapping[str, Any]
                                ) -> dict[str, torch.Tensor]:
    """The JAX package's SD UNet params (``uurg_tpu/models/sd_unet.py``),
    as nested dicts of arrays, -> a state dict of
    :class:`uurg_torch.models.sd_unet.SDUNet` (:func:`sd_unet_torch_name`):
    HWIO conv kernels become OIHW, Dense kernels are transposed."""
    out = {}
    for path, v in _flatten(params).items():
        v = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        out[sd_unet_torch_name(path)] = torch.tensor(np.ascontiguousarray(v))
    return out


def jax_clip_text_params_to_torch(params: Mapping[str, Any]
                                  ) -> dict[str, torch.Tensor]:
    """The JAX package's CLIP text encoder params
    (``uurg_tpu/models/clip_text.py``) -> a state dict of
    :class:`uurg_torch.models.clip_text.CLIPTextEncoder`: the token table
    as ``token_embed.weight``, the rest as :func:`_flax_names_to_torch`."""
    out = _flax_names_to_torch(params)
    out["token_embed.weight"] = out.pop("token_embed.embedding")
    return out


def load_reference_checkpoint(path: str, model: torch.nn.Module,
                              use_ema: bool = False) -> int:
    """Load a reference list-format ``ckpt.pth`` ([model_sd, opt_sd, step,
    ema_sd], ``module.``-prefixed keys) into ``model`` with ``strict=True``;
    ``use_ema`` takes the EMA shadow when the file has one. Returns the
    step."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    sd = states[0]
    if use_ema and len(states) > 3 and isinstance(states[-1], dict):
        sd = states[-1]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    sd.pop("logvar", None)          # bayesian variant only; not a UNet weight
    model.load_state_dict(sd, strict=True)
    return int(states[2])


def _prefixed(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {f"module.{k}": v.detach().cpu()
            for k, v in model.state_dict().items()}


def save_reference_checkpoint(path: str, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, step: int,
                              ema_model: torch.nn.Module | None = None) -> None:
    """Write the reference list format ``[model_sd, opt_sd, step, ema_sd]``
    (``module.``-prefixed keys, as the reference's DataParallel model saves
    them; ``ema_sd`` left out without an EMA model). The file is written
    beside ``path`` and renamed over it, so a reader never sees half of
    it."""
    states = [_prefixed(model), optimizer.state_dict(), int(step)]
    if ema_model is not None:
        states.append(_prefixed(ema_model))
    tmp = f"{path}.tmp"
    torch.save(states, tmp)
    os.replace(tmp, path)


def load_training_checkpoint(path: str, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer,
                             ema_model: torch.nn.Module | None = None) -> int:
    """Read back what :func:`save_reference_checkpoint` wrote: the model,
    the optimizer state and, when given an EMA model, its shadow (which the
    file must hold). Returns the step."""
    states = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(
        {k.removeprefix("module."): v for k, v in states[0].items()},
        strict=True)
    optimizer.load_state_dict(states[1])
    if ema_model is not None:
        if len(states) < 4:
            raise ValueError(f"{path} holds no EMA shadow")
        ema_model.load_state_dict(
            {k.removeprefix("module."): v for k, v in states[3].items()},
            strict=True)
    return int(states[2])
