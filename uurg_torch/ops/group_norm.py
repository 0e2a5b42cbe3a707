"""GroupNorm forward over NHWC activations with fp32 statistics.

Port of ``uurg_tpu/ops/group_norm.py``. ``group_norm`` is the dispatcher:
for a CUDA tensor it launches the hand-written kernel in
``uurg_torch/csrc/group_norm.cu`` (which replaces the Pallas
``_gn_fwd_kernel``), for a CPU tensor it runs :func:`group_norm_plain`. It
never falls back from one to the other. Both compute ``_gn_reference``:
``var = max(E[x^2] - mean^2, 0)``, ``y = x * a + b`` with
``a = rstd * scale``, ``b = bias - mean * a``, all in fp32, y in x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from uurg_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_CHUNK_BYTES = 16
_MAX_CHUNKS = 512   # C / (16 / itemsize): one thread per 16-byte column chunk


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     groups: int, eps: float, return_stats: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xr = x.reshape(b, -1, groups, cg).float()
    mean = xr.mean(dim=(1, 3), keepdim=True)
    mean2 = xr.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(mean2 - mean * mean, min=0.0) + eps)
    a = rstd * scale.float().reshape(1, 1, groups, cg)
    bterm = bias.float().reshape(1, 1, groups, cg) - mean * a
    y = (xr * a + bterm).reshape(x.shape).to(x.dtype)
    if return_stats:
        return y, mean.reshape(b, groups), rstd.reshape(b, groups)
    return y


def _check(x, scale, bias, groups):
    if x.ndim != 4:
        raise ValueError(f"group_norm wants NHWC x, got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must have shape ({c},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale and bias must be float32")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels-last NCHW "
                         "permuted to NHWC)")
    if not (x.device == scale.device == bias.device):
        raise ValueError("x, scale and bias must be on one device")
    if c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")


def _launch_fn():
    fn = _build.load("group_norm").uurg_group_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               groups: int = 32, eps: float = 1e-6,
               return_stats: bool = False):
    """GroupNorm over the channel axis of contiguous NHWC ``x``.

    Returns y, or ``(y, mean, rstd)`` with (B, G) fp32 statistics when
    ``return_stats``. The group count is halved until it divides C, as the
    JAX dispatcher does for narrow test configs."""
    c = x.shape[-1]
    while c % groups != 0:
        groups //= 2
    _check(x, scale, bias, groups)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, groups, eps, return_stats)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the GroupNorm kernel takes bfloat16 or float32, "
                        f"not {x.dtype}")
    per_chunk = _CHUNK_BYTES // x.element_size()
    if c % per_chunk != 0 or c // per_chunk > _MAX_CHUNKS:
        raise ValueError(f"the GroupNorm kernel needs C a multiple of "
                         f"{per_chunk} and at most {per_chunk * _MAX_CHUNKS}, "
                         f"got {c}")
    if x.data_ptr() % _CHUNK_BYTES:
        raise ValueError("the GroupNorm kernel needs a 16-byte aligned x")
    b, h, w, _ = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = _launch_fn()(
        x.data_ptr(), scale.contiguous().data_ptr(),
        bias.contiguous().data_ptr(), y.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), b, h * w, c, groups, eps, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed: CUDA error {err}")
    group_norm.launches += 1
    return (y, mean, rstd) if return_stats else y


group_norm.launches = 0
