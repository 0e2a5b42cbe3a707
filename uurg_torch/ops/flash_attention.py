"""Attention: softmax(q k^T / sqrt(D)) v on (B, H, T, D), and its gradient.

Port of ``uurg_tpu/ops/flash_attention.py``. ``attention`` is the
dispatcher. For a CUDA tensor it launches the hand-written kernel in
``uurg_torch/csrc/flash_attention_fwd.cu`` (which replaces the Pallas
``_attn_kernel``) at every T, the T = 16 mid site included; for a CPU tensor
it runs :func:`attention_plain`, the ``_reference_attention`` formulation.
When a gradient is wanted it goes through one ``torch.autograd.Function``
whose backward is :func:`attention_bwd`: the kernels of
``uurg_torch/csrc/flash_attention_bwd.cu`` (which replace the Pallas
``_attn_bwd_kernel``) for a CUDA tensor, :func:`attention_bwd_plain` for a
CPU tensor. Nothing falls back from a kernel to a plain version.

The kernels are Hopper designs (``sm_90a``): persistent warp-specialised
blocks, tiles loaded by TMA through tensor maps that the C launchers encode
at every call, every product a ``wgmma``; see the notes at the head of the
two sources and ``uurg_torch/csrc/hopper_mma.cuh``. A launcher returns the
CUDA error code of its launch, or -1 if a tensor map could not be encoded;
the wrappers raise on either.

Head widths: the kernels are compiled for D in {64, 128, 192, 256}. Other
widths up to 256 are zero-padded to the next multiple of 64 (padded k
columns add zero to the scores, padded v columns are sliced off, and the
padded gradient columns are zero and sliced off) and the kernels are given
the true ``D ** -0.5`` scale, so no pre-scaling of q is needed.
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


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor):
    """Plain version of the Pallas ``_attn_bwd_kernel``'s arithmetic (not
    autograd of :func:`attention_plain`): P recomputed in fp32,
    dP = g v^T, delta = rowsum(P * dP), dS = P (dP - delta) / sqrt(D);
    dq = dS k and dk = dS^T q with dS in q's dtype, dv = P^T g with P in g's
    dtype, fp32 accumulation. Returns (dq, dk, dv) in q's, k's, v's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*ts):
    q = ts[0]
    if q.ndim != 4:
        raise ValueError(f"attention wants (B, H, T, D), got {tuple(q.shape)}")
    if any(t.shape != q.shape for t in ts):
        raise ValueError("q, k and v must have one shape (self-attention)")
    if any(t.dtype != q.dtype for t in ts) or not q.is_floating_point():
        raise TypeError("q, k and v must share one floating dtype")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k and v must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k and v must be contiguous")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")


def _kernel_width(q: torch.Tensor) -> int:
    """The padded head width the kernels take, after the checks they need."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bfloat16, not {q.dtype}")
    Dp = -(-q.shape[-1] // 64) * 64
    if Dp not in _KERNEL_D:
        raise ValueError(f"the attention kernels take head width <= 256, "
                         f"got {q.shape[-1]}")
    return Dp


def _padded(ts, Dp: int):
    D = ts[0].shape[-1]
    out = [t if Dp == D else F.pad(t, (0, Dp - D)) for t in ts]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("the attention kernels need 16-byte aligned tensors")
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_fn():
    return _build.function(
        "flash_attention_fwd", "uurg_attention_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                      ctypes.c_void_p])


def _bwd_fn():
    return _build.function(
        "flash_attention_bwd", "uurg_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                       ctypes.c_void_p])


def _attention_kernel(q, k, v, with_lse: bool):
    """Launch the forward kernel: (o, lse or None), lse fp32 (B*H, T)."""
    B, H, T, D = q.shape
    Dp = _kernel_width(q)
    q, k, v = _padded((q, k, v), Dp)
    o = torch.empty_like(q)
    lse = (torch.empty((B * H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = _fwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr() if with_lse else None, B * H, T, Dp,
                    D ** -0.5, _stream(q))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    attention.launches += 1
    return (o if Dp == D else o[..., :D]), lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor | None, g: torch.Tensor):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient g.

    CPU tensors: :func:`attention_bwd_plain` (o and lse are not needed).
    CUDA tensors: the kernels, which take the forward's output o and its
    fp32 (B*H, T) log-sum-exp ``lse``; all of q, k, v, o, g contiguous
    (B, H, T, D) bf16."""
    _check(q, k, v, o, g)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g)
    B, H, T, D = q.shape
    if lse is None or lse.shape != (B * H, T) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("the attention backward kernels need the forward's "
                         "contiguous fp32 (B*H, T) log-sum-exp")
    Dp = _kernel_width(q)
    q, k, v, o, g = _padded((q, k, v, o, g), Dp)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, T, Dp,
                    D ** -0.5, _stream(q))
    if err != 0:
        raise RuntimeError(
            f"attention backward kernel launch failed: CUDA error {err}")
    attention_bwd.launches += 1
    if Dp != D:
        dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The op with a gradient: the kernel and its backward kernels on CUDA,
    the plain versions on the CPU (the same saved tensors either way)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            o, lse = attention_plain(q, k, v), None
        else:
            o, lse = _attention_kernel(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # the gradient may arrive in any stride order (reshape, permute); o
        # is a column slice of the kernel's output where D was padded
        return attention_bwd(q, k, v, o.contiguous(), lse, g.contiguous())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, (B, H, T, D) layout. Differentiable when
    grad mode is on and an input requires grad; otherwise (sampling,
    ``torch.inference_mode``) one forward launch with no saved state."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _attention_kernel(q, k, v, with_lse=False)[0]


attention.launches = 0
attention_bwd.launches = 0
