"""Attention: softmax(q k^T / sqrt(D)) v on (B, H, T, D), and its gradient.

Port of ``uurg_tpu/ops/flash_attention.py``. ``attention`` is the
dispatcher. For a CUDA tensor it launches a hand-written kernel (which
replaces the Pallas ``_attn_kernel``) at every T, the T = 16 mid site
included: ``uurg_torch/csrc/flash_attention_fwd.cu`` for bfloat16,
``uurg_torch/csrc/flash_attention_f32.cu`` for float32 (the ViT
classifiers' default); for a CPU tensor it runs :func:`attention_plain`, the
``_reference_attention`` formulation. When a gradient is wanted it goes
through one ``torch.autograd.Function`` whose backward is
:func:`attention_bwd`: the kernels of ``uurg_torch/csrc/flash_attention_bwd.cu``
(bfloat16) or ``flash_attention_f32.cu`` (float32), which replace the Pallas
``_attn_bwd_kernel``, for a CUDA tensor, :func:`attention_bwd_plain` for a
CPU tensor. Nothing falls back from a kernel to a plain version, and no
other dtype reaches a kernel: a CUDA tensor of any other dtype raises.
Inside :func:`uurg_torch.parallel.sequence.sequence_parallel` the
dispatcher hands a call whose token counts divide by the ``seq`` axis to
ring attention, which runs these kernels a chunk.

The bfloat16 kernels are Hopper designs (``sm_90a``): persistent
warp-specialised blocks, tiles loaded by TMA through tensor maps that the C
launchers encode at every call, every product a ``wgmma``; see the notes at
the head of the two sources and ``uurg_torch/csrc/hopper_mma.cuh``. The
float32 kernels keep float32 precision (plain TF32 would cost ~1e-3) on one
of four routes that :func:`_f32_plan` picks from the shape, the first three
FFMA on the CUDA cores: ``tiled`` (head width 64: warps own 16 whole rows,
the streamed operand in a cp.async ring, five products backward with dS^T
through fp32 scratch for dq), ``packed`` (width 64 and T <= 16: several
heads share a warp's rows), ``wide`` (padded widths 128-256: the first
register-tiled design) and ``xwide`` (padded widths 320-512, the forward
only: the VAE's one head of width 512; 64 resident query rows, K and V
streamed in chunks, both products on the tensor cores as three TF32
products of split operands, "3xTF32"). A launcher
returns the CUDA error code of its launch, or -1 if a tensor map could not
be encoded; the wrappers raise on either. Each wrapper counts its launches
per route: ``attention.launches`` and ``attention_bwd.launches`` for
bfloat16, ``attention.launches_f32`` and ``attention_bwd.launches_f32`` for
float32 (one a call, whatever the route).

Head widths and layouts. The bfloat16 kernels take any head width D that
is a multiple of 8, up to 256, as it is: their tensor maps have the true
width as their first dimension and each tensor's own strides, and TMA fills
the part of a 64-column tile past D with zeros (:func:`_bf16_plan`). So q,
k, v, the forward's output and the output gradient are read where they lie,
in any layout whose last dimension is contiguous: DiT's heads are views of
its fused qkv projection, and for such token-major q the output is written
into a (B, T, H, D) buffer, so that merging the heads back is a view too.
Only a width that is not a multiple of 8 (no model of the repository has
one) is zero-padded to the next multiple of 64 first. The float32 kernels
take contiguous tensors of a width that is a multiple of 64, up to 256 (up
to 512 forward; ROADMAP.md lists the wider backward and a bfloat16 forward
above 256 as capability items, which raise here): their dispatcher
copies strided inputs and zero-pads other widths (padded k columns add zero
to the scores, padded v columns and gradient columns are zero and sliced
off). Every kernel is given the true ``D ** -0.5`` scale.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from uurg_torch.ops import _build

_KERNEL_D = (64, 128, 192, 256)
# the float32 forward's extra-wide widths (the xwide route)
_XWIDE_D = (320, 384, 448, 512)
_WIDE_ITEM = ("is a capability item of ROADMAP.md (Queue 2); no path of the "
              "port needs it (the VAE is frozen)")
# the bfloat16 kernels' tensor maps: every stride a multiple of 16 bytes
_STRIDE_ELEMS = 8
# float32 routes (the launchers' route codes) and their bounds: heads of
# T <= _PACK_T are packed floor(_PACK_T / T) to a warp's 16 rows; the tiled
# backward's dS^T scratch pads T to a multiple of _DS_PAD (the dq kernel's
# query block)
_F32_ROUTES = {"wide": 0, "tiled": 1, "packed": 2, "xwide": 3}
_PACK_T = 16
_DS_PAD = 64


class F32Plan(NamedTuple):
    route: str                      # "tiled", "packed", "wide" or "xwide"
    scratch: tuple[int, int, int] | None    # dS^T (B*H, Tp, Tp), fp32


def _f32_plan(B: int, H: int, T: int, D: int,
              backward: bool = False) -> F32Plan:
    """The float32 kernels' route for (B, H, T, D) (of the backward with
    ``backward``) and the backward's fp32 scratch shape; raises where the C
    launchers would refuse the shape. The tiled backward writes dS^T there
    ([head][key][query], T padded to Tp), which a second kernel reads for
    dq = dS K: B*H*Tp^2 floats, 154 MB at ViT-B/16's (64, 12, 197, 64).
    Widths above 256 have a forward only (``xwide``)."""
    if min(B, H, T, D) < 1:
        raise ValueError(f"attention needs a non-empty (B, H, T, D), got "
                         f"{(B, H, T, D)}")
    Dp = -(-D // 64) * 64
    if Dp in _XWIDE_D:
        if backward:
            raise NotImplementedError(
                f"the float32 attention backward at head width {D} (above "
                f"256) {_WIDE_ITEM}")
        return F32Plan("xwide", None)
    if Dp not in _KERNEL_D:
        raise ValueError(f"the float32 attention kernels take head width "
                         f"<= 512, got {D}")
    if Dp > 64:
        return F32Plan("wide", None)
    if T <= _PACK_T:
        return F32Plan("packed", None)
    Tp = -(-T // _DS_PAD) * _DS_PAD
    return F32Plan("tiled", (B * H, Tp, Tp))


def _wide(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 for float64 inputs (precision references)."""
    return t if t.dtype == torch.float64 else t.float()


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, p cast to v's dtype
    before the PV product, fp32 accumulation, output in q's dtype (float64
    throughout for float64 inputs)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(_wide(p.to(v.dtype)), _wide(v)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor):
    """Plain version of the Pallas ``_attn_bwd_kernel``'s arithmetic (not
    autograd of :func:`attention_plain`): P recomputed in fp32,
    dP = g v^T, delta = rowsum(P * dP), dS = P (dP - delta) / sqrt(D);
    dq = dS k and dk = dS^T q with dS in q's dtype, dv = P^T g with P in g's
    dtype, fp32 accumulation (float64 throughout for float64 inputs).
    Returns (dq, dk, dv) in q's, k's, v's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = _wide(q), _wide(k), _wide(v), _wide(g)
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(_wide(ds.to(k.dtype)), kf)
    dk = torch.matmul(_wide(ds.to(q.dtype)).transpose(-1, -2), qf)
    dv = torch.matmul(_wide(p.to(g.dtype)).transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _layout_error(t: torch.Tensor) -> str | None:
    """Why the kernels cannot read ``t`` where it lies, or None. The last
    dimension must be contiguous. Where the width is a multiple of 8 (the
    kernels read such tensors unpadded), every other stride of a dimension
    longer than 1 must be a positive multiple of 8 elements and the data
    16-byte aligned, as TMA wants; other widths are padded into a fresh
    contiguous tensor first, which meets both."""
    shape, stride = t.shape, t.stride()
    if stride[-1] != 1 and shape[-1] > 1:
        return f"must be contiguous in the last dimension (strides {stride})"
    if shape[-1] % _STRIDE_ELEMS:
        return None
    if any(n > 1 and (st <= 0 or st % _STRIDE_ELEMS)
           for n, st in zip(shape[:-1], stride[:-1])):
        return (f"must be contiguous in the last dimension with its other "
                f"strides positive multiples of {_STRIDE_ELEMS} elements "
                f"(strides {stride})")
    if t.data_ptr() % 16:
        return ("must be contiguous in the last dimension with 16-byte "
                "aligned data")
    return None


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
    _check_layout(ts)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"attention runs on cuda or cpu, not {q.device}")


def _check_layout(ts):
    for t in ts:
        err = _layout_error(t)
        if err is not None:
            raise ValueError(f"q, k and v {err}")


Strides = tuple[int, int, int]


class Bf16Plan(NamedTuple):
    Dp: int                    # the template width: shared-memory tiles
    D: int                     # the true head width
    width: int                 # the width the kernels are handed: D, or Dp
    pad: bool                  # zero-pad to Dp first (D % 8 != 0)
    strides: tuple[Strides, ...]   # each tensor's (over T, H, B), elements
    token_major: bool          # the forward writes o into (B, T, H, D)
    out: Strides               # the forward output's strides


def _bf16_plan(*ts) -> Bf16Plan:
    """How the bfloat16 kernels take (B, H, T, D) tensors ``ts`` (q, k, v,
    or q, k, v, o, g): the template width, the true width, whether a pad is
    needed (only where D % 8 != 0, to the template width), each tensor's
    element strides over T, H and B as the tensor maps get them (a
    dimension of length 1 gets its contiguous stride, which it never
    steps), and the layout of the forward's output: token-major (B, T, H, D)
    where q is (a view of a fused projection), else contiguous. Raises,
    with "contiguous" in the message, where the kernels cannot read a
    tensor where it lies (the rest of :func:`_check` is the caller's).
    Plain Python: the CPU tests reach it."""
    _check_layout(ts)
    B, H, T, D = ts[0].shape
    Dp = _kernel_width(ts[0])
    pad = D % _STRIDE_ELEMS != 0
    width = Dp if pad else D
    dense = (width, T * width, H * T * width)

    def strides(t) -> Strides:
        if pad:
            return dense
        sb, sh, st = t.stride()[:3]
        return (st if T > 1 else dense[0], sh if H > 1 else dense[1],
                sb if B > 1 else dense[2])

    st = tuple(strides(t) for t in ts)
    token_major = st[0][1] < st[0][0]
    out = (H * width, width, T * H * width) if token_major else dense
    return Bf16Plan(Dp, D, width, pad, st, token_major, out)


def _kernel_width(q: torch.Tensor) -> int:
    """The padded head width the kernels take, after the checks they need."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the attention kernels take bfloat16 or float32, "
                        f"not {q.dtype}")
    Dp = -(-q.shape[-1] // 64) * 64
    if Dp in _XWIDE_D:
        if q.dtype == torch.float32:
            return Dp
        raise NotImplementedError(
            f"the bfloat16 attention kernels at head width {q.shape[-1]} "
            f"(above 256) {_WIDE_ITEM}")
    if Dp not in _KERNEL_D:
        raise ValueError(f"the attention kernels take head width <= 256 "
                         f"(float32 forward: <= 512), got {q.shape[-1]}")
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
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])


def _bwd_fn():
    return _build.function(
        "flash_attention_bwd", "uurg_attention_bwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])


def _c_strides(strides) -> ctypes.Array:
    flat = [x for st in strides for x in st]
    return (ctypes.c_longlong * len(flat))(*flat)


def _fwd_f32_fn():
    return _build.function(
        "flash_attention_f32", "uurg_attention_fwd_f32",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _bwd_f32_fn():
    return _build.function(
        "flash_attention_f32", "uurg_attention_bwd_f32",
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _attention_kernel(q, k, v, with_lse: bool):
    """Launch the forward kernel of q's dtype: (o, lse or None), lse fp32
    (B*H, T)."""
    B, H, T, D = q.shape
    Dp = _kernel_width(q)
    lse = (torch.empty((B * H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lse_ptr = lse.data_ptr() if with_lse else None
    f32 = q.dtype == torch.float32
    if f32:
        # the float32 kernels take contiguous tensors of the template width
        # until their redesign at the true width: strided inputs are copied
        q, k, v = _padded([t.contiguous() for t in (q, k, v)], Dp)
        o = torch.empty_like(q)
        route = _F32_ROUTES[_f32_plan(B, H, T, D).route]
        err = _fwd_f32_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse_ptr, B * H, T, Dp, D ** -0.5,
                            route, _stream(q))
    else:
        plan = _bf16_plan(q, k, v)
        if plan.pad:
            q, k, v = _padded((q, k, v), Dp)
        o = (torch.empty((B, T, H, plan.width), dtype=q.dtype,
                         device=q.device).transpose(1, 2)
             if plan.token_major else
             torch.empty((B, H, T, plan.width), dtype=q.dtype,
                         device=q.device))
        err = _fwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse_ptr, B, H, T, plan.width,
                        _c_strides(plan.strides + (plan.out,)), D ** -0.5,
                        _stream(q))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    if f32:
        attention.launches_f32 += 1
    else:
        attention.launches += 1
    return (o if o.shape[-1] == D else o[..., :D]), lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor | None, g: torch.Tensor):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient g.

    CPU tensors: :func:`attention_bwd_plain` (o and lse are not needed).
    CUDA tensors: the kernels of q's dtype, which take the forward's output
    o and its fp32 (B*H, T) log-sum-exp ``lse``; q, k, v, o, g (B, H, T, D),
    bf16 or fp32, in any layout :func:`_check` accepts. The gradients are
    contiguous (B, H, T, D)."""
    _check(q, k, v, o, g)
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, g)
    B, H, T, D = q.shape
    if lse is None or lse.shape != (B * H, T) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("the attention backward kernels need the forward's "
                         "contiguous fp32 (B*H, T) log-sum-exp")
    Dp = _kernel_width(q)
    delta = torch.empty_like(lse)
    f32 = q.dtype == torch.float32
    if f32:
        plan = _f32_plan(B, H, T, D, backward=True)
        # contiguous tensors of the template width, as in the forward
        q, k, v, o, g = _padded([t.contiguous() for t in (q, k, v, o, g)], Dp)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        scratch = (torch.empty(plan.scratch, dtype=torch.float32,
                               device=q.device) if plan.scratch else None)
        err = _bwd_f32_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, T, Dp,
            D ** -0.5, _F32_ROUTES[plan.route], _stream(q))
    else:
        plan = _bf16_plan(q, k, v, o, g)
        if plan.pad:
            q, k, v, o, g = _padded((q, k, v, o, g), Dp)
        dq, dk, dv = (torch.empty((B, H, T, plan.width), dtype=q.dtype,
                                  device=q.device) for _ in range(3))
        err = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), g.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, H, T, plan.width,
                        _c_strides(plan.strides), D ** -0.5, _stream(q))
    if err != 0:
        raise RuntimeError(
            f"attention backward kernel launch failed: CUDA error {err}")
    if f32:
        attention_bwd.launches_f32 += 1
    else:
        attention_bwd.launches += 1
    if dq.shape[-1] != D:
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
        # the kernels read g where it lies (MHSA's merge hands back a
        # token-major view); a layout they cannot read (the expanded
        # gradient of a sum, a permutation that moves the last dimension)
        # is copied into a fresh contiguous tensor
        if _layout_error(g) is not None:
            g = g.clone(memory_format=torch.contiguous_format)
        return attention_bwd(q, k, v, o, lse, g)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, (B, H, T, D) layout. Differentiable when
    grad mode is on and an input requires grad; otherwise (sampling,
    ``torch.inference_mode``) one forward launch with no saved state.
    Inside :func:`uurg_torch.parallel.sequence.sequence_parallel` a call
    whose q and k token counts both divide by the ``seq`` axis goes to
    ring attention; any other stays local."""
    _check(q, k, v)
    from uurg_torch.parallel.mesh import mesh_shape
    from uurg_torch.parallel.sequence import (active_sequence_parallel,
                                              ring_attention)
    sp = active_sequence_parallel()
    if sp is not None:
        mesh, axis, batch_axis = sp
        n = mesh_shape(mesh)[axis]
        if q.shape[2] % n == 0 and k.shape[2] % n == 0:
            return ring_attention(q, k, v, mesh=mesh, axis=axis,
                                  batch_axis=batch_axis)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _attention_kernel(q, k, v, with_lse=False)[0]


attention.launches = 0
attention.launches_f32 = 0
attention_bwd.launches = 0
attention_bwd.launches_f32 = 0
