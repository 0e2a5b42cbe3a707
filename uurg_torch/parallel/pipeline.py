"""Pipeline parallelism over DiT's blocks: GPipe's fill/drain schedule on
``torch.distributed``.

Port of ``uurg_tpu/parallel/pipeline.py``. Stage s of the ``stage`` axis
owns blocks ``[s d / S, (s + 1) d / S)`` (:func:`shard_params_pp`); the
batch is split into M microbatches that flow through the stages. At tick t
of ``M + S - 1`` each stage runs its blocks on microbatch ``t - s`` when
there is one (no compute in the bubble) and passes the activation to stage
s + 1 (``batch_isend_irecv``, neighbours only); stage 0 takes a fresh
microbatch each tick. The trunk ends as JAX's does, the last stage's output
broadcast to every stage, so the final layer and the loss run on every
rank. The embedders and the final layer are replicated.

The whole trunk is one ``autograd.Function``: its forward keeps each
microbatch's graph through the stage's blocks (under the model's own remat
policy), and its backward runs the schedule in reverse explicitly, each
stage's gradient of its input passed to stage s - 1. No send or receive
sits in the autograd graph, whose engine would order them itself (and
neighbouring ranks could then wait on each other for ever). The gradients
of the embedders and the final layer come out equal to one device's on
every rank: the conditioning's gradient is summed over the stages (each
block's share once) and the input's comes from stage 0; the conditioning
passes through the trunk, so that the final layer's share of its gradient
joins the blocks' on the last stage, in one device's order (one stage and
one microbatch give one device's bits).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from uurg_torch.parallel.mesh import (DATA, STAGE, AxisRing, axis_ring,
                                      mesh_shape, shard_params_pp,
                                      stage_blocks)

__all__ = ["stage_block_apply", "pipeline_blocks", "dit_embed", "dit_final",
           "dit_apply_pipelined", "shard_params_pp"]


def stage_block_apply(model, blocks: range):
    """One stage: ``(h, c) -> h`` through ``model``'s blocks ``blocks`` in
    order, each as the model runs it (its remat policy)."""

    def stage(h, c):
        for i in blocks:
            h = model._block(model.blocks[i], h, c)
        return h

    return stage


def _exchange(ring: AxisRing, send, to: int, recv, frm: int) -> None:
    """Send ``send`` to global rank ``to`` and receive ``recv`` from
    ``frm`` at once, either may be None; nothing when both are."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to, ring.group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm, ring.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _fill_drain(stage_fn, ring: AxisRing, h_mb, c_mb, graphs: bool):
    """The forward schedule: (the last stage's outputs (M, mb, T, D) on
    every stage, and with ``graphs`` each microbatch's (input, condition,
    output) leaves of its graph through this stage)."""
    s, S, M = ring.index, ring.size, h_mb.shape[0]
    outs, saved, carry = [None] * M, [], None
    for t in range(M + S - 1):
        m = t - s
        live = 0 <= m < M
        recv = torch.empty_like(h_mb[0]) if s > 0 and live else None
        _exchange(ring, carry, ring.next, recv, ring.prev)
        carry = None
        if not live:
            continue
        h_in, c_in = (h_mb[m] if s == 0 else recv), c_mb[m]
        if graphs:
            h_in = h_in.detach().requires_grad_()
            c_in = c_in.detach().requires_grad_()
            with torch.enable_grad():
                h = stage_fn(h_in, c_in)
            saved.append((h_in, c_in, h))
        else:
            h = stage_fn(h_in, c_in)
        if s == S - 1:
            outs[m] = h.detach()
        else:
            carry = h.detach()
    out = torch.stack(outs) if s == S - 1 else torch.empty_like(h_mb)
    if S > 1:
        dist.broadcast(out, src=ring.ranks[S - 1], group=ring.group)
    return out, saved


def _drain_fill(ring: AxisRing, saved, g_out, g_c):
    """The backward schedule, the forward's ticks in reverse: each
    microbatch's graph through this stage run backward from the gradient
    of its output (the trunk's on the last stage, stage s + 1's input
    gradient elsewhere); on the last stage the conditioning's gradient
    from the final layer ``g_c`` enters first. Returns (the gradient of
    the trunk's input, from stage 0, and of the conditioning, summed over
    the stages), each (M, mb, ...) on every stage."""
    s, S, M = ring.index, ring.size, g_out.shape[0]
    dh, dc, carry = [None] * M, [None] * M, None
    for t in reversed(range(M + S - 1)):
        m = t - s
        live = 0 <= m < M
        recv = torch.empty_like(g_out[0]) if s < S - 1 and live else None
        _exchange(ring, carry, ring.prev, recv, ring.next)
        carry = None
        if not live:
            continue
        h_in, c_in, h = saved[m]
        g = g_out[m] if s == S - 1 else recv
        if s == S - 1:
            torch.autograd.backward([c_in, h], [g_c[m], g])
        else:
            torch.autograd.backward(h, g)
        dc[m] = c_in.grad
        if s == 0:
            dh[m] = h_in.grad
        else:
            carry = h_in.grad
    dc = torch.stack(dc)
    dh = torch.stack(dh) if s == 0 else torch.empty_like(g_out)
    if S > 1:
        dist.all_reduce(dc, group=ring.group)
        dist.broadcast(dh, src=ring.ranks[0], group=ring.group)
    return dh, dc


class _Pipeline(torch.autograd.Function):
    """The pipelined trunk: (h_mb, c_mb) -> (the trunk's output, c_mb
    passed through for the final layer)."""

    @staticmethod
    def forward(ctx, h_mb, c_mb, stage_fn, ring):
        out, ctx.graphs = _fill_drain(stage_fn, ring, h_mb, c_mb, True)
        ctx.ring = ring
        return out, c_mb.clone()

    @staticmethod
    def backward(ctx, g_out, g_c):
        dh, dc = _drain_fill(ctx.ring, ctx.graphs, g_out, g_c)
        del ctx.graphs
        return dh, dc, None, None


def pipeline_blocks(stage_fn, h_mb: torch.Tensor, c_mb: torch.Tensor, *,
                    mesh, axis: str = STAGE):
    """Run microbatches through the stages of ``axis``.

    Args:
      stage_fn: ``(h, c) -> h`` through this stage's blocks
        (:func:`stage_block_apply`).
      h_mb: (M, mb, T, D) microbatched activations, the same on every
        stage (this rank's ``data`` rows: each data slice runs its own
        pipeline, with no traffic across slices).
      c_mb: (M, mb, D) per-microbatch conditioning, alike.

    Returns ((M, mb, T, D) trunk outputs, ``c_mb`` passed through), the
    same on every stage: the final layer takes the conditioning from here,
    so that its gradient joins the blocks' in one device's order.
    Differentiable when grad mode is on and h or c requires grad."""
    ring = axis_ring(mesh, axis)
    if torch.is_grad_enabled() and (h_mb.requires_grad
                                    or c_mb.requires_grad):
        return _Pipeline.apply(h_mb, c_mb, stage_fn, ring)
    return _fill_drain(stage_fn, ring, h_mb, c_mb, False)[0], c_mb


def dit_embed(model, x, t, y, cond_keep=None):
    """DiT's input stem (patchify, position embedding, t and y
    conditioning): ``model.embed``, the first part of ``DiT.forward``."""
    return model.embed(x, t, y, cond_keep)


def dit_final(model, h, c, out_shape):
    """DiT's output head (final adaLN, linear, unpatchify):
    ``model.head``, the last part of ``DiT.forward``."""
    return model.head(h, c, out_shape)


def dit_apply_pipelined(model, cfg, x, t, y, *, mesh, n_microbatches: int,
                        axis: str = STAGE, cond_keep=None):
    """DiT's forward with the blocks pipelined over ``axis``: a drop-in
    for ``model(x, t, y, cond_keep)`` on a model placed by
    :func:`shard_params_pp` (or whole on every stage). x, t, y are this
    rank's rows of the global batch (all of it without a ``data`` axis),
    split into ``n_microbatches`` along dimension 0. JAX's ``ValueError``s
    for ``scan_blocks=False``, a global batch the microbatches do not
    divide, a microbatch size the ``data`` axis does not divide and a
    depth the stages do not divide."""
    if not cfg.scan_blocks:
        raise ValueError("pipelining needs the scan (depth-stacked) layout")
    M = n_microbatches
    shape = mesh_shape(mesh)
    n_data = shape.get(DATA, 1)
    B = x.shape[0] * n_data
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    if DATA in shape and (B // M) % n_data:
        raise ValueError(
            f"microbatch size {B // M} not divisible by the data axis "
            f"({n_data}) for dp x pp")
    stage_fn = stage_block_apply(model, stage_blocks(cfg.depth, mesh, axis))
    h, c = dit_embed(model, x, t, y, cond_keep)
    out, c = pipeline_blocks(stage_fn, h.unflatten(0, (M, -1)),
                             c.unflatten(0, (M, -1)), mesh=mesh, axis=axis)
    return dit_final(model, out.flatten(0, 1), c.flatten(0, 1), x.shape)
