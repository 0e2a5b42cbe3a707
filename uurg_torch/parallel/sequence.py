"""Sequence (context) parallelism: ring attention over a ``seq`` mesh axis.

Port of ``uurg_tpu/parallel/sequence.py``. The JAX package shards the
activations along tokens inside one ``shard_map``; here the ranks of a
``seq`` group meet at each attention call:

- each rank holds the whole activations of its ``data`` rows, so
  everything outside attention runs replicated over ``seq`` and the
  parameter gradients come out equal on every ``seq`` rank with no extra
  reduction (no memory is saved outside attention);
- at an attention call the rank takes its token shard of q, k and v (the
  slice's backward gathers the cotangent over ``seq``), runs the ring and
  gathers the output over ``seq`` (the gather's backward takes its own
  slice);
- each ring step runs the port's forward kernel on its chunk
  (``_attention_kernel(q, k, v, with_lse=True)``) and merges the chunks
  by their log-sum-exp in float32, while the k and v chunks move to rank +
  1 with ``batch_isend_irecv``;
- the backward (one ``autograd.Function``) moves k and v around again and
  runs the backward kernels on each chunk with the merged output and
  log-sum-exp (``attention_bwd(q, k_j, v_j, o, lse, g)``: the kernels take
  P = exp(s - lse) and delta = rowsum(o g), the whole row's); dq
  accumulates in float32 and each chunk's dk and dv travel with it, in
  float32, back to their owner.

The arithmetic of a rank (:func:`ring_forward`, :func:`ring_backward`)
takes the chunks as an iterable, so that the transfers are apart from it:
:func:`ring_attention` feeds it the ring, :func:`ring_attention_loopback`
feeds one process all the ranks at once, stacked along the batch, each
step's chunks rolled one rank on (S kernel calls a direction for S ranks).
On one rank the ring is the one-device call, with no transfer.

On CUDA tensors the chunks run the hand-written kernels or raise; on CPU
tensors their plain versions (:func:`chunk_attention_plain`,
:func:`chunk_attention_bwd_plain`). The log-sum-exp is in natural-log
units, as the kernels store it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from uurg_torch.ops import flash_attention as FA
from uurg_torch.parallel.mesh import SEQ, axis_ring, mesh_shape

_ACTIVE_SP: list[tuple] = []


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = SEQ, batch_axis: str = "data"):
    """Route every attention call of the port's models made inside this
    context (``ops.flash_attention.attention``, the dispatcher, consults
    it) through :func:`ring_attention` over ``axis`` of ``mesh``. Every
    rank of the axis must make the same calls in the same order, a
    block's recompute under remat included."""
    _ACTIVE_SP.append((mesh, axis, batch_axis))
    try:
        yield
    finally:
        _ACTIVE_SP.pop()


def active_sequence_parallel() -> tuple | None:
    """``(mesh, axis, batch_axis)`` of the innermost context, or None."""
    return _ACTIVE_SP[-1] if _ACTIVE_SP else None


# -- one chunk ----------------------------------------------------------------


def _lse_rows(lse: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The (B*H, T) log-sum-exp as (B, H, T, 1), to scale o's rows."""
    B, H, T, _ = o.shape
    return lse.view(B, H, T, 1)


def chunk_attention_plain(q, k, v):
    """Plain version of ``_attention_kernel(q, k, v, with_lse=True)``: the
    output of :func:`~uurg_torch.ops.flash_attention.attention_plain` (its
    bits) and the natural-log log-sum-exp of the scaled scores, (B*H, T)
    fp32 (float64 for float64 inputs)."""
    B, H, T, D = q.shape
    s = torch.matmul(FA._wide(q), FA._wide(k).transpose(-1, -2)) * D ** -0.5
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(FA._wide(p.to(v.dtype)), FA._wide(v)).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1).reshape(B * H, T)


def chunk_attention_bwd_plain(q, k, v, o, lse, g):
    """Plain version of ``attention_bwd(q, k, v, o, lse, g)`` for one key
    chunk of a longer row: P = exp(s - lse) with the row's log-sum-exp,
    delta = rowsum(o g) with the row's output, dS = P (g v^T - delta) /
    sqrt(D); dq = dS k, dk = dS^T q (dS in q's dtype), dv = P^T g (P in g's
    dtype), fp32 accumulation, each in its input's dtype. With the chunk's
    own o and lse it is the whole attention's backward."""
    D = q.shape[-1]
    scale = D ** -0.5
    qf, kf, vf, gf = (FA._wide(t) for t in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - _lse_rows(lse, o).to(s.dtype))
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (FA._wide(o) * gf).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(FA._wide(ds.to(k.dtype)), kf)
    dk = torch.matmul(FA._wide(ds.to(q.dtype)).transpose(-1, -2), qf)
    dv = torch.matmul(FA._wide(p.to(g.dtype)).transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunk_fwd(q, k, v):
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k, v)
    return FA._attention_kernel(q, k, v, with_lse=True)


def _chunk_bwd(q, k, v, o, lse, g):
    if q.device.type == "cpu":
        FA._check(q, k, v, o, g)
        return chunk_attention_bwd_plain(q, k, v, o, lse, g)
    return FA.attention_bwd(q, k, v, o, lse, g)


# -- a rank's arithmetic ------------------------------------------------------


@dataclasses.dataclass
class Chunk:
    """A k and v chunk on its way around the ring, and the gradient
    accumulators that travel with it (None until the first backward
    step)."""

    k: torch.Tensor
    v: torch.Tensor
    dk: torch.Tensor | None = None
    dv: torch.Tensor | None = None


def _add(acc, x):
    """``acc + x`` in float32 (float64 for float64), in place where
    ``acc`` is already that wide (the ring's own buffers), or ``x`` as it
    is when ``acc`` is None: one chunk's result keeps its own bits."""
    return x if acc is None else FA._wide(acc).add_(x)


def ring_forward(q: torch.Tensor, chunks: Iterable[Chunk]):
    """(o, lse) of the query chunk ``q`` against the k and v chunks that
    ``chunks`` yields, each through the forward kernel (plain version on
    the CPU), merged by their log-sum-exp in float32: o in q's dtype, lse
    (B*H, Tq) fp32. One chunk gives the kernel's own output."""
    o = lse = acc = None
    for c in chunks:
        o_j, lse_j = _chunk_fwd(q, c.k, c.v)
        if o is None:
            o, lse = o_j, lse_j
            continue
        if acc is None:
            acc = FA._wide(o)
        new = torch.logaddexp(lse, lse_j)
        acc.mul_(_lse_rows(torch.exp(lse - new), acc))
        acc.addcmul_(o_j, _lse_rows(torch.exp(lse_j - new), acc))
        lse = new
    return (o if acc is None else acc.to(q.dtype)), lse


def ring_backward(q: torch.Tensor, chunks: Iterable[Chunk], o, lse, g):
    """dq of the query chunk ``q`` for the output gradient ``g``, given
    the merged output ``o`` and log-sum-exp ``lse`` of :func:`ring_forward`;
    each chunk's dk and dv are added to its accumulators in place. The
    backward kernels (plain version on the CPU) run once a chunk; dq and
    the accumulators sum in float32 from the second chunk on."""
    dq = None
    for c in chunks:
        dq_j, dk_j, dv_j = _chunk_bwd(q, c.k, c.v, o, lse, g)
        dq = _add(dq, dq_j)
        c.dk, c.dv = _add(c.dk, dk_j), _add(c.dv, dv_j)
    return dq.to(q.dtype)


class _Around:
    """The chunks a rank meets: ``chunk`` (its own) at step 0, then at each
    of ``steps - 1`` further steps the one ``pass_on`` brings from the
    previous rank as this one leaves. With ``grads`` the accumulators
    travel too, and after the last step they take the last hop home:
    ``home`` then holds this rank's own chunk with its gradients."""

    def __init__(self, chunk: Chunk, pass_on: Callable, steps: int,
                 grads: bool = False):
        self.chunk, self.pass_on, self.steps = chunk, pass_on, steps
        self.grads, self.home = grads, None

    def _next(self, c: Chunk, kv: bool) -> Chunk:
        send = [c.k, c.v] if kv else []
        if self.grads:
            send += [FA._wide(c.dk), FA._wide(c.dv)]
        got = self.pass_on(send)
        return Chunk(*got) if kv else Chunk(self.chunk.k, self.chunk.v, *got)

    def __iter__(self):
        c = self.chunk
        for j in range(self.steps):
            yield c
            if j < self.steps - 1:
                c = self._next(c, kv=True)
        if self.grads and self.steps > 1:
            c = self._next(c, kv=False)
        self.home = c


# -- the rings ----------------------------------------------------------------


class _Ring:
    """The ranks of a ``seq`` group: this rank's token shard, the chunks'
    passage to rank + 1 (``batch_isend_irecv``), the gather of the
    ranks' shards."""

    def __init__(self, mesh, axis: str):
        self.axis = axis_ring(mesh, axis)

    @property
    def size(self) -> int:
        return self.axis.size

    def local(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2] // self.size
        return x.narrow(2, self.axis.index * n, n)

    def pass_on(self, tensors: list) -> list:
        ax = self.axis
        send = [t.contiguous() for t in tensors]
        got = [torch.empty_like(t) for t in send]
        ops = [dist.P2POp(dist.isend, t, ax.next, ax.group) for t in send]
        ops += [dist.P2POp(dist.irecv, t, ax.prev, ax.group) for t in got]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return got

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The shards' (..., T/S, D) concatenated along tokens (dim -2)."""
        if self.size == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.axis.group)
        return torch.cat(parts, dim=-2)


class _Loopback:
    """All S ranks in this process, stacked along the batch: rank r's rows
    of a (B, H, T, D) tensor are row b * S + r of a (B * S, H, T / S, D)
    one (a view of DiT's token-major q, k and v), and passing the chunks
    on rolls them one rank along."""

    def __init__(self, size: int):
        self.size = size

    def local(self, x: torch.Tensor) -> torch.Tensor:
        B, H, T, D = x.shape
        S = self.size
        return x.unflatten(2, (S, T // S)).transpose(1, 2).reshape(
            B * S, H, T // S, D)

    def pass_on(self, tensors: list) -> list:
        S = self.size
        return [t.unflatten(0, (t.shape[0] // S, S)).roll(1, dims=1)
                .flatten(0, 1) for t in tensors]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., B * S, H, T / S, D) -> (..., B, H, T, D)."""
        S = self.size
        x = x.unflatten(-4, (x.shape[-4] // S, S))     # (..., B, S, H, Tl, D)
        return x.transpose(-4, -3).flatten(-3, -2)


def _local_forward(q, k, v, ring):
    """This rank's token shard of q, k and v, and the ring's (o, lse) for
    its q."""
    ql, kl, vl = (ring.local(t) for t in (q, k, v))
    return (ql, kl, vl,
            *ring_forward(ql, _Around(Chunk(kl, vl), ring.pass_on,
                                      ring.size)))


class _RingAttention(torch.autograd.Function):
    """Ring attention with its gradient: the token shard, the ring, the
    gather forward; the cotangent's shard, the ring backward, the
    gradients' gather backward."""

    @staticmethod
    def forward(ctx, q, k, v, ring):
        ql, kl, vl, o, lse = _local_forward(q, k, v, ring)
        ctx.save_for_backward(ql, kl, vl, o, lse)
        ctx.ring = ring
        return ring.gather(o)

    @staticmethod
    def backward(ctx, g):
        ql, kl, vl, o, lse = ctx.saved_tensors
        ring = ctx.ring
        gl = ring.local(g)
        # a layout the kernels cannot read is copied, as the one-device
        # backward does
        if FA._layout_error(gl) is not None:
            gl = gl.clone(memory_format=torch.contiguous_format)
        around = _Around(Chunk(kl, vl), ring.pass_on, ring.size, grads=True)
        dq = ring_backward(ql, around, o, lse, gl)
        dk, dv = around.home.dk.to(kl.dtype), around.home.dv.to(vl.dtype)
        if ring.size == 1:
            return dq, dk, dv, None
        return (*ring.gather(torch.stack([dq, dk, dv])).unbind(0), None)


def _run(q, k, v, ring) -> torch.Tensor:
    FA._check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, ring)
    return ring.gather(_local_forward(q, k, v, ring)[3])


def ring_attention(q, k, v, *, mesh, axis: str = SEQ,
                   batch_axis: str = "data") -> torch.Tensor:
    """Exact softmax attention of (B, H, T, D) q, k, v with the tokens
    shared out over ``axis`` of ``mesh``: every rank of the axis passes the
    same whole tensors and gets the whole output (its own token shard's
    from the ring, the others' gathered). T must divide by the axis size
    (``ValueError``). The rows are this rank's over ``batch_axis`` already
    (the runners cut every batch by it), so the ring runs among the ranks
    of this rank's ``data`` slice: dp x sp composes with no traffic across
    slices. Differentiable when grad mode is on and an input requires
    grad."""
    S = mesh_shape(mesh)[axis]
    T = q.shape[2]
    if T % S:
        raise ValueError(f"token count {T} not divisible by seq axis {S}")
    return _run(q, k, v, _Ring(mesh, axis))


def ring_attention_loopback(q, k, v, seq: int) -> torch.Tensor:
    """The arithmetic of ring attention over ``seq`` ranks, all in this
    process: the ranks stacked along the batch, ``seq`` forward kernel
    calls (and ``seq`` backward calls under autograd) on (B * seq, H,
    T / seq, D) chunks, the chunks and their gradient accumulators rolled
    one rank on between steps as the ring passes them. Same result as
    :func:`ring_attention` on ``seq`` ranks."""
    if q.shape[2] % seq:
        raise ValueError(f"token count {q.shape[2]} not divisible by seq "
                         f"axis {seq}")
    return _run(q, k, v, _Loopback(seq))
