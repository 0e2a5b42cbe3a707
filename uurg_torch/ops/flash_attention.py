"""Attention forward: softmax(q k^T / sqrt(D)) v on (B, H, T, D).

Port of ``uurg_tpu/ops/flash_attention.py``. ``attention`` is the
dispatcher: for a CUDA tensor it launches the hand-written kernel in
``uurg_torch/csrc/flash_attention_fwd.cu`` (which replaces the Pallas
``_attn_kernel``) at every T, the T = 16 mid site included; for a CPU tensor
it runs :func:`attention_plain`, the ``_reference_attention`` formulation.
It never falls back from one to the other.

Head widths: the kernel is compiled for D in {64, 128, 192, 256}. Other
widths up to 256 are zero-padded to the next multiple of 64 (padded k
columns add zero to the scores, padded v columns are sliced off) and the
kernel is given the true ``D ** -0.5`` scale, so no pre-scaling of q is
needed.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from uurg_torch.ops import _build

_KERNEL_D = (64, 128, 192, 256)


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, p cast to v's dtype
    before the PV product, fp32 accumulation, output in q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check(q, k, v):
    if q.ndim != 4:
        raise ValueError(f"attention wants (B, H, T, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must have one shape (self-attention)")
    if not (q.dtype == k.dtype == v.dtype) or not q.is_floating_point():
        raise TypeError("q, k and v must share one floating dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _launch_fn():
    fn = _build.load("flash_attention_fwd").uurg_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, (B, H, T, D) layout."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, not {q.dtype}")
    B, H, T, D = q.shape
    Dp = -(-D // 64) * 64
    if Dp not in _KERNEL_D:
        raise ValueError(f"the attention kernel takes head width <= 256, got {D}")
    if Dp != D:
        pad = (0, Dp - D)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the attention kernel needs 16-byte aligned q, k, v")
    o = torch.empty_like(q)
    err = _launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       B * H, T, Dp, D ** -0.5,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    attention.launches += 1
    return o if Dp == D else o[..., :D]


attention.launches = 0
