"""Tensor parallel: Megatron's paired operators and the layers' parallel
forward.

The JAX package's tensor parallel is a set of partition specs
(``uurg_tpu/parallel/mesh.py``): pjit inserts the all-reduce at every
row-parallel product and the matching one in the backward. Here the
parameters that :func:`uurg_torch.parallel.mesh.shard_params_tp` places are
DTensors over the ``model`` axis, the layers compute on their local shards
as plain tensors, and the collectives are these ``autograd.Function``s:

- copy-to-model before a column-parallel layer: identity forward, the
  input gradient all-reduced over the axis backward (each rank holds the
  part of it that its output features give);
- reduce-from-model after a row-parallel product, before its whole bias:
  the partial outputs all-reduced forward, identity backward;
- gather-from-model for the adaLN modulation, whose six pieces modulate
  whole activations: the ranks' outputs gathered into the one-device
  order forward, this rank's slice of the gradient backward (the gradient
  above it is whole and the same on every rank of the axis, so no
  reduce-scatter).

Activations between the blocks stay whole, and every rank of the axis runs
the rest of the model on the same values. The sums travel in float32: a
row-parallel product's bfloat16 partial outputs (and a column-parallel
layer's input gradients) are summed in float32 and cast once, the closest
a ``model=N`` result comes to one device's single rounding. On a one-rank
axis a sum is the identity, and the row-parallel layer keeps its bias
inside the product as one device does, so a one-rank mesh gives one
device's bits. A parameter that no rule shards takes the one-device call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from uurg_torch.parallel.mesh import tp_pieces


def model_size(weight: torch.Tensor) -> int:
    """The ranks of the ``model`` axis over which a tensor-parallel
    parameter is sharded; 1 for any other tensor."""
    return weight.device_mesh.size() if tp_pieces(weight) else 1


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in float32 (a new tensor)."""
    s = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(s, group=group)
    return s


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _sum_f32(grad, ctx.group).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The float32 sum over the axis; its gradient goes back in the
    partial output's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' last dimensions, each ``pieces`` slices, gathered into
    the one-device order of the pieces."""

    @staticmethod
    def forward(ctx, x, pieces, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.pieces, ctx.n, ctx.r = pieces, n, r
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        m = x.shape[-1] // pieces
        whole = torch.stack(parts, dim=-2)        # (..., n, pieces * m)
        whole = whole.unflatten(-1, (pieces, m)).transpose(-3, -2)
        return whole.flatten(-3)                   # (..., pieces * n * m)

    @staticmethod
    def backward(ctx, grad):
        g = grad.unflatten(-1, (ctx.pieces, ctx.n, -1))[..., ctx.r, :]
        return g.flatten(-2).contiguous(), None, None


def copy_to_model(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` going into the column-parallel layer of ``weight``."""
    return _CopyToModel.apply(x, weight.device_mesh.get_group())


def gather_from_model(y: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The whole output (one-device order) of the column-parallel layer of
    ``weight`` from this rank's ``y``; ``y`` itself when ``weight`` is not
    tensor-parallel."""
    pieces = tp_pieces(weight)
    if not pieces:
        return y
    return _GatherFromModel.apply(y, pieces, weight.device_mesh.get_group())


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` of ``x`` with ``weight`` and ``bias`` cast to
    ``dtype``; on a tensor-parallel ``weight``, its column-parallel
    (dimension 0: the local output features, ``x`` through copy-to-model)
    or row-parallel (dimension 1: ``x`` holds the local input features,
    the partial outputs reduced, the whole bias added after, in float32,
    one cast) form."""
    if tp_pieces(weight) is None:
        return F.linear(x, weight.to(dtype),
                        None if bias is None else bias.to(dtype))
    w = weight.to_local().to(dtype)
    if weight.placements[0].dim == 0:
        b = None if bias is None else bias.to_local().to(dtype)
        return F.linear(copy_to_model(x, weight), w, b)
    b = None if bias is None else bias.to(dtype)
    group = weight.device_mesh.get_group()
    if model_size(weight) == 1:
        return _ReduceFromModel.apply(F.linear(x, w, b), group).to(dtype)
    out = _ReduceFromModel.apply(F.linear(x, w), group)
    if b is not None:
        out = out + b.float()
    return out.to(dtype)
