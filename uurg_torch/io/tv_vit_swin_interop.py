"""torchvision ViT-B/16 and Swin checkpoints -> the port's ViT and Swin.

Port of ``uurg_tpu/io/tv_vit_swin_interop.py``. The reference builds its ViT
and Swin classifiers from torchvision with ImageNet weights and a
re-initialised head (Classification/models/vit.py:4-8,
Classification/models/swin.py:4-19); without a download the ``.pth`` is
supplied locally. The port's models keep the JAX package's module names
(:mod:`uurg_torch.models.vit`, :mod:`uurg_torch.models.swin`), so the keys
are renamed; layouts are torch's on both sides, so only two tensors change:

- ViT attention: torchvision's ``in_proj_weight`` stacks [q; k; v] along the
  output dimension, each head-major, which is the port's fused ``qkv``
  Linear as it is.
- ViT head: the reference assigns ``model.head = nn.Linear(...)`` but
  torchvision's forward calls ``self.heads``, so the re-initialised head is
  dangling and the trained logits come from ``heads.head``. The converter
  takes ``heads.head`` and returns bare ``head.*`` keys in ``dropped``.
- Swin patch merging: torchvision concatenates the 2x2 sub-grid as
  [(h0,w0), (h1,w0), (h0,w1), (h1,w1)], the port (as the JAX model) as
  [(h0,w0), (h0,w1), (h1,w0), (h1,w1)], so the 4C axis of the merge
  LayerNorm and of the reduction weight is permuted by C-sized blocks
  [0, 2, 1, 3] (:func:`_merge_perm`).
- Swin ``relative_position_index`` is a buffer the port recomputes; dropped.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import torch


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().float().contiguous()


def _merge_perm(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Permute a 4C axis from torchvision's sub-grid order to the port's
    ([0, 2, 1, 3] blocks)."""
    b = torch.chunk(v, 4, dim=axis)
    return torch.cat([b[0], b[2], b[1], b[3]], dim=axis).contiguous()


_VIT_BLOCK = {"ln_1": "ln1", "ln_2": "ln2", "self_attention.out_proj":
              "attn.proj", "mlp.0": "fc1", "mlp.linear_1": "fc1",
              "mlp.3": "fc2", "mlp.linear_2": "fc2"}


def torch_vit_to_port(state_dict: Mapping[str, Any], strict: bool = True
                      ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A torchvision ``vit_b_16``-layout state dict -> the port's ViT state
    dict. Returns ``(state_dict, dropped)``; with ``strict`` a key neither
    mapped nor dropped raises ValueError."""
    keys = {k.removeprefix("module."): v for k, v in state_dict.items()}
    has_tv_head = any(k.startswith("heads.") for k in keys)
    out: dict[str, torch.Tensor] = {}
    dropped, unknown = [], []
    for k, v in keys.items():
        leaf = k.rsplit(".", 1)[-1]
        if k == "class_token":
            out["cls_token"] = _t(v)
        elif k == "encoder.pos_embedding":
            out["pos_embed"] = _t(v)
        elif k.startswith("conv_proj."):
            out[f"patch_embed.{leaf}"] = _t(v)
        elif k.startswith("encoder.ln."):
            out[f"ln_final.{leaf}"] = _t(v)
        elif k.startswith("heads."):
            out[f"head.{leaf}"] = _t(v)
        elif k.startswith("head."):
            if has_tv_head:
                dropped.append(k)         # the reference's dangling re-init
            else:
                out[f"head.{leaf}"] = _t(v)
        elif (m := re.fullmatch(
                r"encoder\.layers\.encoder_layer_(\d+)\.(.*)\.(\w+)", k)):
            i, mod, leaf = int(m.group(1)), m.group(2), m.group(3)
            if mod == "self_attention" and leaf.startswith("in_proj_"):
                out[f"block_{i}.attn.qkv.{leaf[len('in_proj_'):]}"] = _t(v)
            elif mod in _VIT_BLOCK:
                out[f"block_{i}.{_VIT_BLOCK[mod]}.{leaf}"] = _t(v)
            else:
                unknown.append(k)
        else:
            unknown.append(k)
    if unknown and strict:
        raise ValueError(f"unrecognized torch ViT keys: {unknown[:8]}"
                         f"{'...' if len(unknown) > 8 else ''}")
    return out, dropped


_SWIN_BLOCK = {"norm1": "ln1", "norm2": "ln2", "attn.qkv": "attn.qkv",
               "attn.proj": "attn.proj", "mlp.0": "fc1", "mlp.3": "fc2"}


def torch_swin_to_port(state_dict: Mapping[str, Any], strict: bool = True
                       ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A torchvision ``swin_t/s/b``-layout state dict -> the port's Swin
    state dict. ``features.0`` is the patch embedding, odd ``features`` are
    stages, even ones above 0 patch mergings. Returns ``(state_dict,
    dropped)``; ``dropped`` holds the ``relative_position_index`` buffers."""
    out: dict[str, torch.Tensor] = {}
    dropped, unknown = [], []
    for key, v in state_dict.items():
        k = key.removeprefix("module.")
        parts = k.split(".")
        leaf = parts[-1]
        if parts[0] == "norm":
            out[f"ln_final.{leaf}"] = _t(v)
        elif parts[0] == "head":
            out[f"head.{leaf}"] = _t(v)
        elif parts[0] == "features" and parts[1] == "0":
            # features.0.0 = Conv2d, features.0.2 = LayerNorm
            out[f"{'patch_embed' if parts[2] == '0' else 'ln_embed'}."
                f"{leaf}"] = _t(v)
        elif parts[0] == "features" and int(parts[1]) % 2 == 0:
            base = f"merge{int(parts[1]) // 2 - 1}"
            if parts[2] == "norm":
                out[f"{base}.ln.{leaf}"] = _merge_perm(_t(v), 0)
            elif parts[2] == "reduction":            # (2C, 4C), no bias
                out[f"{base}.reduction.{leaf}"] = _merge_perm(_t(v), 1)
            else:
                unknown.append(key)
        elif parts[0] == "features":
            base = f"stage{(int(parts[1]) - 1) // 2}_block{int(parts[2])}"
            mod = ".".join(parts[3:-1])
            if mod == "attn" and leaf == "relative_position_bias_table":
                out[f"{base}.attn.rel_pos_bias"] = _t(v)
            elif mod == "attn" and leaf == "relative_position_index":
                dropped.append(key)                  # recomputed
            elif mod in _SWIN_BLOCK:
                out[f"{base}.{_SWIN_BLOCK[mod]}.{leaf}"] = _t(v)
            else:
                unknown.append(key)
        else:
            unknown.append(key)
    if unknown and strict:
        raise ValueError(f"unrecognized torch Swin keys: {unknown[:8]}"
                         f"{'...' if len(unknown) > 8 else ''}")
    return out, dropped


def _load(path: str, convert):
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return convert(obj)


def load_torch_vit_checkpoint(path: str
                              ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A torchvision ViT ``.pth`` (bare, or under ``state_dict``/``model``)
    -> ``(state_dict, dropped)`` under the port's names."""
    return _load(path, torch_vit_to_port)


def load_torch_swin_checkpoint(path: str
                               ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A torchvision Swin ``.pth`` -> ``(state_dict, dropped)``."""
    return _load(path, torch_swin_to_port)
