"""Device meshes, batch splits, FSDP, tensor-parallel and pipeline
placement on ``torch.distributed``.

Port of ``uurg_tpu/parallel/mesh.py``.
The JAX package names a ``jax.sharding.Mesh`` and lets pjit insert the
collectives; here a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
of processes (one card each) and the collectives are explicit:

- data parallel: each rank takes its block of rows of every global batch
  (:func:`shard_batch`) and draws the randomness of the whole batch before
  keeping its rows (:func:`batch_split`, read by ``core/rng.py``); the
  engine averages the gradients over the group (:func:`all_reduce_mean_`).
- FSDP: FSDP2's ``fully_shard`` shards each parameter on the dimension
  :func:`fsdp_spec` picks, JAX's rule; the small and indivisible ones stay
  whole, as JAX replicates them, and their gradients are averaged by hand.
- tensor parallel: path rules (:data:`DIT_TP_RULES`, :data:`SD_TP_RULES`)
  make the attention and MLP projections DTensors sharded over the
  ``model`` axis, Megatron's column and row pairs; the layers run on their
  shards with the paired operators of :mod:`uurg_torch.parallel.tensor`,
  which pjit inserts on the JAX side.
- pipeline: stage s of the ``stage`` axis owns DiT's blocks
  ``[s d / S, (s + 1) d / S)`` (:func:`shard_params_pp`); on the other
  stages their parameters are empty, marked with their owner and whole
  shape (:func:`stage_owned`), as are the moments and masks placed like
  them. :mod:`uurg_torch.parallel.pipeline` runs the schedule.

Every helper that gives or takes a whole tensor (:func:`local_slice`,
:func:`shard_like`, :func:`full_tensor`, :func:`full_state_dict`, the
optimizer state's pair) works in the one-device layout, so masks, Fishers,
checkpoints and resume see no sharding.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import re
import sys
import warnings
from typing import Any, Iterable, Mapping, NamedTuple

import torch
import torch.distributed as dist

from uurg_torch.parallel.dist import initialize_single, is_initialized

log = logging.getLogger("uurg_torch.parallel")

DATA, MODEL, STAGE, SEQ = "data", "model", "stage", "seq"


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device_type: str | None = None):
    """A ``DeviceMesh`` over the ranks of the default group, its dimensions
    named in the order of ``axis_sizes`` (default: one ``data`` axis over
    every rank). ``-1`` fills the remaining ranks; more ranks than the group
    has raise ``ValueError``, fewer warn (the mesh takes the first ones).
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``. Without a
    group, one of this process alone is started first."""
    from torch.distributed.device_mesh import DeviceMesh

    if not is_initialized():
        initialize_single(device_type)
    world = dist.get_world_size()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if not axis_sizes:
        axis_sizes = {DATA: world}
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world // known
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} need {total} "
                         f"ranks, only {world} available")
    if total < world:
        warnings.warn(f"mesh axes {dict(zip(names, sizes))} use {total} of "
                      f"{world} ranks; use -1 on one axis to fill the rest",
                      stacklevel=2)
    return DeviceMesh(device_type, torch.arange(total).reshape(sizes),
                      mesh_dim_names=tuple(names))


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse a CLI mesh spec like ``"data=4,model=2"`` (``-1`` fills the
    remaining ranks, as in :func:`make_mesh`)."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition("=")
        if not _ or not name:
            raise ValueError(f"bad mesh spec {spec!r}: expected name=size "
                             f"pairs, got {part!r}")
        out[name.strip()] = int(size)
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class AxisRing(NamedTuple):
    """This rank's place on a mesh axis: its ``index`` of ``size``, the
    axis's process group and the global ranks along it (``ranks``, in axis
    order; ``next`` and ``prev`` this rank's neighbours on the ring)."""

    index: int
    size: int
    group: Any
    ranks: tuple

    @property
    def next(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.index - 1) % self.size]


def axis_ring(mesh, axis: str) -> AxisRing:
    """This rank's :class:`AxisRing` on ``axis`` of ``mesh`` (a group of
    the ranks that share every other coordinate with this one), kept on
    the mesh: every attention call under ring attention asks for it."""
    rings = mesh.__dict__.setdefault("_axis_rings", {})
    if axis not in rings:
        shape = mesh_shape(mesh)
        if axis not in shape:
            raise ValueError(f"the mesh {shape} has no {axis!r} axis")
        group = mesh.get_group(axis)
        rings[axis] = AxisRing(mesh.get_local_rank(axis), shape[axis], group,
                               tuple(dist.get_process_group_ranks(group)))
    return rings[axis]


# the axis each mode shards over, and JAX's refusal of a mesh without it
_MODE_AXES = {"pp": (STAGE, "--mesh stage=4"),
              "sp": (SEQ, "--mesh seq=4 or --mesh data=2,seq=4")}


def require_axis(mesh, parallelism: str) -> None:
    """JAX's ``ValueError`` when ``parallelism`` is ``pp`` or ``sp`` and
    ``mesh`` lacks its ``stage`` or ``seq`` axis; nothing otherwise."""
    if parallelism in _MODE_AXES:
        axis, example = _MODE_AXES[parallelism]
        if axis not in mesh_shape(mesh):
            raise ValueError(f"parallelism={parallelism!r} needs a {axis!r} "
                             f"mesh axis — pass e.g. {example}")


def _resolve_axis(mesh, axis: str) -> str | None:
    """The mesh axis to shard over: ``axis`` when the mesh has it, else the
    largest axis (``fsdp`` on a ``data=N`` mesh shards over ``data``, ZeRO
    style), else None when no axis is larger than 1."""
    shape = mesh_shape(mesh)
    if axis in shape:
        return axis
    best = max(shape, key=lambda n: shape[n], default=None)
    if best is None or shape[best] == 1:
        return None
    return best


# -- batches ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """Rows ``[index * n, (index + 1) * n)`` of every global batch of
    ``count * n`` rows are this rank's; ``group`` is the data axis's
    process group (None on one device)."""

    index: int = 0
    count: int = 1
    group: Any = None


# the split in force in this process, as torch's grad mode is: the draws
# it shapes sit deep in models (dropout) whose calls carry a generator
# only. Set and restored by split_batches alone
_SPLIT = BatchSplit()


def batch_split() -> BatchSplit:
    """The split in force (one device: index 0 of 1)."""
    return _SPLIT


def _split_of(mesh) -> BatchSplit:
    if mesh is None or DATA not in mesh_shape(mesh):
        return BatchSplit()
    return BatchSplit(mesh.get_local_rank(DATA), mesh_shape(mesh)[DATA],
                      mesh.get_group(DATA))


@contextlib.contextmanager
def split_batches(mesh):
    """Within the block, the random draws of a loss or a sampler are made
    for the global batch and cut to this rank's rows over the ``data``
    axis of ``mesh`` (JAX draws the sharded batch's randomness as the
    one-device draw), and the adaptive loss's normalizer is summed over
    the axis. A mesh without the axis, or None, leaves every batch
    whole."""
    global _SPLIT
    before, _SPLIT = _SPLIT, _split_of(mesh)
    try:
        yield _SPLIT
    finally:
        _SPLIT = before


def local_rows(x: torch.Tensor, split: BatchSplit | None = None,
               dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` itself on one
    device). Raises when the split's count does not divide the rows."""
    split = split or _SPLIT
    if split.count == 1:
        return x
    n = x.shape[dim]
    if n % split.count:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{split.count} ranks")
    k = n // split.count
    return x.narrow(dim, split.index * k, k)


def shard_batch(batch, mesh, batch_dim: int = 0):
    """This rank's rows of every tensor or array in ``batch`` (nested
    tuples and lists): the block ``[i * B / n, (i + 1) * B / n)`` of
    dimension ``batch_dim`` at coordinate ``i`` of the ``data`` axis, JAX's
    contiguous ``P('data')`` block. ``batch_dim=1`` is for ``[grad_accum,
    B, ...]`` stacks. Without the axis the batch stays whole."""
    split = _split_of(mesh)

    def cut(x):
        if isinstance(x, (tuple, list)):
            return type(x)(cut(v) for v in x)
        return local_rows(x if torch.is_tensor(x) else torch.as_tensor(x),
                          split, batch_dim)

    return cut(batch)


def gather_rows(x: torch.Tensor, split: BatchSplit | None = None
                ) -> torch.Tensor:
    """The global batch from every rank's block of rows (dimension 0), on
    every rank; ``x`` itself on one device."""
    split = split or _SPLIT
    if split.count == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(split.count)]
    dist.all_gather(parts, x.contiguous(), group=split.group)
    return torch.cat(parts)


# -- whole tensors ------------------------------------------------------------


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from rank 0 over the
    default group, in place. Returns ``module``; nothing happens without a
    group."""
    if is_initialized():
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(local(t), src=0)
    return module


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Average every tensor over ``group`` in place: one flat SUM
    all-reduce a dtype, then a division by the group's size (gloo has no
    AVG)."""
    size = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


# -- sharded tensors ----------------------------------------------------------


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor. Without ``torch.distributed.tensor``
    imported no tensor can be one, and it is not imported for the check."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage: writes go through);
    any other tensor itself."""
    return t._local_tensor if is_sharded(t) else t


# the attribute a tensor-parallel parameter (and a tensor placed like it)
# carries: the number of fused pieces along its sharded dimension
_PIECES = "_tp_pieces"


def tp_pieces(t) -> int | None:
    """The fused pieces along a tensor-parallel DTensor's sharded dimension
    (1 for a plain projection, 3 for qkv, 6 for adaLN, 2 for GEGLU), as
    :func:`shard_params_tp` recorded it on the parameter and
    :func:`shard_like` / :func:`zeros_like` carry it; None for any other
    tensor."""
    return getattr(t, _PIECES, None)


def _carry_pieces(t: torch.Tensor, like) -> torch.Tensor:
    k = tp_pieces(like)
    if k is not None:
        setattr(t, _PIECES, k)
    return t


def zeros_like(t: torch.Tensor) -> torch.Tensor:
    """``torch.zeros_like(t)``, placed as ``t`` is, its pieces or its
    stage too (a gradient buffer)."""
    z = _carry_pieces(torch.zeros_like(t), t)
    owned = stage_owned(t)
    if owned is not None:
        setattr(z, _STAGE_OWNED, owned)
    return z


def _piece_slice(full: torch.Tensor, dim: int, pieces: int, n: int,
                 index: int) -> torch.Tensor:
    """Shard ``index`` of ``n`` along ``dim`` of the one-device ``full``:
    the index-th slice of each of its ``pieces`` fused pieces, in order."""
    if pieces == 1:
        return full.chunk(n, dim=dim)[index]
    return torch.cat([p.chunk(n, dim=dim)[index]
                      for p in full.chunk(pieces, dim=dim)], dim=dim)


def _piece_order(gathered: torch.Tensor, dim: int, pieces: int,
                 n: int) -> torch.Tensor:
    """The one-device layout of ``n`` shards of :func:`_piece_slice`
    concatenated in rank order along ``dim``."""
    if pieces == 1:
        return gathered
    m = gathered.shape[dim] // (n * pieces)
    return gathered.unflatten(dim, (n, pieces, m)).transpose(
        dim, dim + 1).flatten(dim, dim + 2)


def local_slice(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of the whole (one-device layout) tensor ``full`` that this
    rank holds of the DTensor or stage-owned tensor ``like`` (``full`` when
    ``like`` is whole; an empty tensor on a stage that does not own it). No
    communication."""
    owned = stage_owned(like)
    if owned is not None:
        return full if owned.here else full.new_empty(0)
    if not is_sharded(like):
        return full
    mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
    pieces = tp_pieces(like) or 1
    out = full
    for i, placement in enumerate(like.placements):
        if placement.is_shard():
            out = _piece_slice(out, placement.dim, pieces, mesh.size(i),
                               coord[i])
    return out


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as the DTensor ``like`` is (its mesh, placements and
    pieces, this rank's slice, no communication), or as the stage-owned
    ``like`` is (whole on its stage, empty on the others); ``full`` when
    ``like`` is whole."""
    if not is_sharded(like):
        return local_slice(full, like)
    from torch.distributed.tensor import DTensor

    part = local_slice(full, like).to(local(like).device).contiguous()
    return _carry_pieces(DTensor.from_local(
        part, like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride()), like)


def full_tensor(t: torch.Tensor, like: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The whole tensor of a DTensor in the one-device layout (a
    collective: every rank of its mesh calls it), of a stage-owned tensor
    (broadcast from its stage over the ``stage`` group), any other tensor
    itself. The pieces and the owner are read from ``like`` when given (an
    optimizer moment of the parameter ``like``; a state of another shape,
    Adam's step count, is not placed like it), else from ``t``."""
    owned = stage_owned(t if like is None else like)
    if owned is not None and (like is None or t.shape == like.shape):
        if owned.group is None:
            return t
        whole = t if owned.here else t.new_empty(owned.shape)
        dist.broadcast(whole, src=owned.src, group=owned.group)
        return whole
    if not is_sharded(t):
        return t
    whole = t.full_tensor()
    pieces = tp_pieces(t if like is None else like)
    if pieces:
        dim = next(p.dim for p in t.placements if p.is_shard())
        whole = _piece_order(whole, dim, pieces, t.device_mesh.size())
    return whole


def full_state_dict(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors on the CPU in the
    one-device layout (a collective under FSDP, tensor parallel and the
    pipeline)."""
    params = dict(module.named_parameters())
    return {k: full_tensor(v.detach(), params.get(k)).cpu()
            for k, v in module.state_dict().items()}


def full_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with whole tensors on the CPU in the one-device
    layout (a collective under FSDP, tensor parallel and the pipeline)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    sd = opt.state_dict()
    sd["state"] = {i: {k: full_tensor(v, params[i]).cpu()
                       if torch.is_tensor(v) else v
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def shard_optimizer_state(sd: dict, opt: torch.optim.Optimizer) -> dict:
    """A whole optimizer state (:func:`full_optimizer_state`) placed as
    ``opt``'s parameters are, ready for ``opt.load_state_dict``."""
    params = [p for g in opt.param_groups for p in g["params"]]
    out = dict(sd)
    out["state"] = {
        i: {k: shard_like(v, params[i])
            if torch.is_tensor(v) and v.shape == whole_shape(params[i])
            else v
            for k, v in st.items()}
        for i, st in sd["state"].items()}
    return out


# -- FSDP ---------------------------------------------------------------------


def fsdp_spec(shape: tuple, axis_size: int,
              min_size: int = 2**14) -> int | None:
    """The dimension of a parameter to shard over an axis of ``axis_size``
    ranks, JAX's rule: the largest dimension the size divides; None (kept
    whole) for parameters under ``min_size`` elements and indivisible
    ones."""
    if not shape or math.prod(shape) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % axis_size == 0:
            return d
    return None


def fsdp_param_specs(model: torch.nn.Module, mesh, axis: str = "model",
                     min_size: int = 2**14) -> dict[str, int | None]:
    """``{parameter name: dimension to shard or None}`` over ``axis`` of
    ``mesh`` (resolved as :func:`_resolve_axis`: a mesh with no axis larger
    than 1 shards nothing)."""
    axis = _resolve_axis(mesh, axis)
    size = mesh_shape(mesh)[axis] if axis is not None else None
    return {n: None if axis is None else fsdp_spec(tuple(p.shape), size,
                                                    min_size)
            for n, p in model.named_parameters()}


def _blocks(model: torch.nn.Module) -> list[torch.nn.Module]:
    """The model's blocks, each an FSDP2 unit: those its ``fsdp_units()``
    names (SD's UNet, whose blocks are named attributes), else the
    elements of its ``ModuleList``s that run a forward of their own,
    looking through containers without one (the CondUNet's per-level
    holders, DiT's ``blocks``)."""
    if hasattr(model, "fsdp_units"):
        return list(model.fsdp_units())
    out: list[torch.nn.Module] = []

    def visit(mod: torch.nn.Module, in_list: bool) -> None:
        for child in mod.children():
            is_list = isinstance(child, (torch.nn.ModuleList,
                                         torch.nn.ModuleDict))
            runs = type(child).forward is not torch.nn.Module.forward
            if in_list and runs and not is_list:
                out.append(child)
            elif is_list or not runs:
                visit(child, in_list or is_list)

    visit(model, False)
    return out


def _fully_shard(model: torch.nn.Module, mesh, axis: str,
                 dims: Mapping[str, int | None]) -> None:
    """FSDP2's ``fully_shard`` over ``axis`` of ``mesh`` (with a ``data``
    axis beside it, FSDP2's hybrid form: replicated over ``data``), the
    model's blocks (:func:`_blocks`, those that hold a parameter it shards)
    first and then the root: each parameter that ``dims`` gives a dimension
    sharded on it, every other one FSDP2's ``ignored_params``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    params = dict(model.named_parameters())
    dim = {id(params[n]): d for n, d in dims.items() if d is not None}
    ignored = {p for p in params.values() if id(p) not in dim}
    if axis != DATA and DATA in mesh_shape(mesh):
        sub = mesh[(DATA, axis)]
    else:
        sub = mesh[axis]
    kw = dict(mesh=sub, shard_placement_fn=lambda p: Shard(dim[id(p)]),
              ignored_params=ignored)
    for block in _blocks(model):
        if any(p not in ignored for p in block.parameters()):
            fully_shard(block, **kw)
    fully_shard(model, **kw)


def shard_params_fsdp(model: torch.nn.Module, mesh, axis: str = "model",
                      min_size: int = 2**14) -> torch.nn.Module:
    """Shard ``model`` in place with FSDP2's ``fully_shard``, its blocks
    (:func:`_blocks`, those that hold a parameter it shards) first and then
    the root: each parameter on the dimension
    :func:`fsdp_param_specs` picks. The parameters it keeps whole are
    FSDP2's ``ignored_params``: they stay plain tensors, as JAX replicates
    them, and FSDP2 does not reduce their gradients (the SFR-on engine
    averages them). When the mesh has a ``data`` axis beside the sharding
    axis this is FSDP2's hybrid form: replicated over ``data``, sharded
    over ``axis``. Returns ``model``; a mesh with no axis larger than 1
    leaves it as it is."""
    resolved = _resolve_axis(mesh, axis)
    if resolved is not None:
        _fully_shard(model, mesh, resolved,
                     fsdp_param_specs(model, mesh, axis, min_size))
    return model


# -- tensor parallel ----------------------------------------------------------
#
# Megatron's column- and row-parallel pairs as path rules, the twins of the
# JAX module's on the port's parameter names and torch's (out, in) weights:
# a column-parallel rule shards dimension 0 (flax's last), a row-parallel
# one dimension 1, over the ``model`` axis. The first matching rule wins; a
# dimension its pieces times the axis size does not divide falls through to
# the fallback, as do unmatched parameters (row-parallel biases among
# them): kept whole, or FSDP-sharded over the same axis. GSPMD reshards a
# fused projection after a contiguous cut; here rank r's shard holds the
# r-th slice of each fused piece, and the layers run on their shards with
# the paired operators of uurg_torch/parallel/tensor.py. One rule the port
# adds, for want of GSPMD: an attention's column and row pair is sharded
# only when the axis size divides its head count, else the whole pair
# falls through (with a warning naming it).

class TPRule(NamedTuple):
    """Parameters whose name ``pattern`` matches (``re.search``) are
    sharded on ``dim`` over the ``model`` axis: 0 column-parallel (output
    features), 1 row-parallel (input features). ``pieces`` fused
    projections lie along ``dim`` (qkv's 3, adaLN's 6, GEGLU's value and
    gate): rank r's shard holds the r-th slice of each."""

    pattern: str
    dim: int
    pieces: int = 1


# DiT blocks: qkv, mlp.fc1 and adaLN column-parallel, attn.proj and
# mlp.fc2 row-parallel; embedders and the final layer whole. JAX names the
# final modulation final_adaLN, which its rule does not match: the port's
# final_layer.adaLN_modulation.1 is kept whole by anchoring on the blocks
DIT_TP_RULES: list[TPRule] = [
    TPRule(r"attn\.qkv\.(weight|bias)$", 0, 3),
    TPRule(r"mlp\.fc1\.(weight|bias)$", 0),
    TPRule(r"^blocks\.\d+\.adaLN_modulation\.1\.(weight|bias)$", 0, 6),
    TPRule(r"attn\.proj\.weight$", 1),
    TPRule(r"mlp\.fc2\.weight$", 1),
]

# SD's spatial transformers: q, k, v and GEGLU column-parallel, to_out and
# ff_out row-parallel; convolutions, norms and embeddings fall through
# (fallback="fsdp" shards those over the same axis)
SD_TP_RULES: list[TPRule] = [
    TPRule(r"attn[12]\.to_[qkv]\.weight$", 0),
    TPRule(r"ff_geglu\.proj\.(weight|bias)$", 0, 2),
    TPRule(r"attn[12]\.to_out\.weight$", 1),
    TPRule(r"ff_out\.weight$", 1),
]


class ParamShard(NamedTuple):
    """A parameter's placement: ``kind`` ``"tp"`` (a rule's, ``pieces``
    fused pieces) or ``"fsdp"`` (the fallback's), on dimension ``dim``."""

    kind: str
    dim: int
    pieces: int = 1


def _head_count(module: torch.nn.Module) -> int | None:
    """An attention's head count: DiT's MHSA ``num_heads``, SD's
    CrossAttention ``heads``; None for any other module."""
    for attr in ("num_heads", "heads"):
        h = getattr(module, attr, None)
        if isinstance(h, int):
            return h
    return None


def tp_param_specs(model: torch.nn.Module, mesh,
                   rules=DIT_TP_RULES, fallback: str = "replicate",
                   fsdp_min_size: int = 2**14
                   ) -> dict[str, ParamShard | None]:
    """``{parameter name: its ParamShard, or None (whole)}`` from the
    rules (first match wins): a matched parameter is sharded on the rule's
    dimension when the ``model`` axis's size times the rule's pieces
    divides it, and its attention's head count splits over the axis;
    otherwise, and unmatched, it takes ``fallback``: whole
    (``"replicate"``) or :func:`fsdp_spec`'s dimension at
    ``fsdp_min_size`` (``"fsdp"``). A mesh without a ``model`` axis
    raises JAX's ``ValueError``."""
    shape = mesh_shape(mesh)
    if MODEL not in shape:
        raise ValueError(
            f"tensor-parallel rules shard over mesh axes [{MODEL!r}] that "
            f"the mesh {shape} does not have — pass e.g. --mesh "
            f"data=-1,model=2 (or use --parallelism fsdp)")
    n = shape[MODEL]
    compiled = [(re.compile(r.pattern), r) for r in rules]

    def fall(p) -> ParamShard | None:
        if fallback != "fsdp":
            return None
        d = fsdp_spec(tuple(p.shape), n, fsdp_min_size)
        return None if d is None else ParamShard("fsdp", d)

    params = dict(model.named_parameters())
    specs: dict[str, ParamShard | None] = {}
    for name, p in params.items():
        rule = next((r for rx, r in compiled if rx.search(name)), None)
        if (rule is not None and rule.dim < p.dim()
                and p.shape[rule.dim] % (rule.pieces * n) == 0):
            specs[name] = ParamShard("tp", rule.dim, rule.pieces)
        else:
            specs[name] = fall(p)
    def owner(name: str) -> str:     # the module of a projection's module
        return ".".join(name.split(".")[:-2])

    whole = {}
    for name, spec in specs.items():
        if spec is not None and spec.kind == "tp":
            heads = _head_count(model.get_submodule(owner(name)))
            if heads and heads % n:
                whole[owner(name)] = heads
    for name in specs:
        if owner(name) in whole:
            specs[name] = fall(params[name])
    if whole:
        warnings.warn(
            f"tensor parallel keeps {len(whole)} attention(s) whole: their "
            f"heads do not split over model={n} "
            f"({', '.join(f'{a}: {h} heads' for a, h in whole.items())})",
            stacklevel=2)
    return specs


def is_tp(t) -> bool:
    """Whether ``t`` is a tensor-parallel parameter (or placed like one)."""
    return tp_pieces(t) is not None


def shard_params_tp(model: torch.nn.Module, mesh, rules=DIT_TP_RULES,
                    fallback: str = "replicate") -> torch.nn.Module:
    """Place ``model`` in place by :func:`tp_param_specs`: each rule's
    parameter becomes a DTensor sharded over the ``model`` axis (rank r's
    slice of each fused piece, the piece count recorded on it); under
    ``fallback="fsdp"`` FSDP2 then shards the fallback's parameters over
    the same axis (the tensor-parallel ones among its ``ignored_params``:
    FSDP2 cannot shard a DTensor again over the dimension it spans). The
    rest stay whole. Returns ``model``."""
    from torch.distributed.tensor import DTensor, Shard

    specs = tp_param_specs(model, mesh, rules, fallback)
    sub = mesh[MODEL]
    n, index = sub.size(), sub.get_local_rank()
    for name, spec in specs.items():
        if spec is None or spec.kind != "tp":
            continue
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        p = getattr(mod, leaf)
        part = _piece_slice(p.detach(), spec.dim, spec.pieces, n, index)
        new = torch.nn.Parameter(DTensor.from_local(
            part.contiguous(), sub, [Shard(spec.dim)], run_check=False,
            shape=p.shape, stride=p.stride()), requires_grad=p.requires_grad)
        setattr(new, _PIECES, spec.pieces)
        setattr(mod, leaf, new)
    fsdp = {k: s.dim for k, s in specs.items()
            if s is not None and s.kind == "fsdp"}
    if fsdp:
        _fully_shard(model, mesh, MODEL, fsdp)
    kinds = [s.kind if s else "whole" for s in specs.values()]
    log.info("tensor parallel over model=%d: %d parameters sharded by the "
             "rules, %d by FSDP, %d whole", n, kinds.count("tp"),
             kinds.count("fsdp"), kinds.count("whole"))
    return model


# -- pipeline -----------------------------------------------------------------

# the attribute a stage-owned parameter carries (on every stage)
_STAGE_OWNED = "_pp_stage"


class StageOwned(NamedTuple):
    """A pipeline parameter's placement: stage ``owner`` of the ``stage``
    axis holds it (``here`` on that stage), whole shape ``shape``; the
    other stages hold an empty tensor. ``group`` is the stage axis's group
    (None on one stage), ``src`` the owner's global rank in it."""

    owner: int
    shape: tuple
    here: bool
    group: Any
    src: int


def stage_owned(t) -> StageOwned | None:
    """A stage-owned parameter's :class:`StageOwned`, None for any other
    tensor."""
    return getattr(t, _STAGE_OWNED, None)


def whole_shape(t: torch.Tensor) -> tuple:
    """The one-device shape of a parameter however it is placed."""
    owned = stage_owned(t)
    return tuple(owned.shape if owned is not None else t.shape)


def stage_blocks(depth: int, mesh, axis: str = STAGE) -> range:
    """The blocks this rank's stage owns: ``[s d / S, (s + 1) d / S)``.
    JAX's ``ValueError`` when the stages do not divide ``depth``."""
    S = mesh_shape(mesh)[axis]
    if depth % S:
        raise ValueError(f"depth {depth} not divisible by {S} stages")
    s = axis_ring(mesh, axis).index
    return range(s * depth // S, (s + 1) * depth // S)


def shard_params_pp(model: torch.nn.Module, mesh,
                    axis: str = STAGE) -> torch.nn.Module:
    """Place ``model`` (a DiT: its ``blocks``) in place for the pipeline:
    stage s keeps blocks ``[s d / S, (s + 1) d / S)``, and on the other
    stages their parameters become empty tensors; each block parameter is
    marked :class:`StageOwned` on every stage. Everything else stays
    whole (replicated), as JAX's ``shard_params_pp`` leaves it. Returns
    ``model``."""
    ring = axis_ring(mesh, axis)
    mine = stage_blocks(len(model.blocks), mesh, axis)
    group = ring.group if ring.size > 1 else None
    for i, block in enumerate(model.blocks):
        owner = i // len(mine)
        here = i in mine
        for mod in block.modules():
            for leaf, p in list(mod.named_parameters(recurse=False)):
                new = p if here else torch.nn.Parameter(
                    p.detach().new_empty(0), requires_grad=p.requires_grad)
                setattr(new, _STAGE_OWNED, StageOwned(
                    owner, tuple(p.shape), here, group, ring.ranks[owner]))
                setattr(mod, leaf, new)
    log.info("pipeline over %s=%d: stage %d owns blocks %s", axis,
             ring.size, ring.index, mine)
    return model


def place_model(model: torch.nn.Module, mesh, parallelism: str = "dp",
                tp_rules=DIT_TP_RULES,
                tp_fallback: str = "replicate") -> torch.nn.Module:
    """A model on ``mesh`` for ``parallelism``: its weights broadcast from
    rank 0, then, under ``fsdp``, sharded (:func:`shard_params_fsdp` over
    the ``model`` axis, or the largest), under ``tp`` placed by
    :func:`shard_params_tp` with ``tp_rules`` and ``tp_fallback``, under
    ``pp`` by :func:`shard_params_pp` (``dp`` and ``sp`` keep it whole).
    Returns ``model``; nothing happens without a mesh."""
    if mesh is None:
        return model
    replicate(model)
    if parallelism == "fsdp":
        shard_params_fsdp(model, mesh)
    elif parallelism == "tp":
        shard_params_tp(model, mesh, tp_rules, tp_fallback)
    elif parallelism == "pp":
        shard_params_pp(model, mesh)
    return model


def place_like(tree: Mapping, model: torch.nn.Module) -> dict:
    """``{name: leaf}`` with each tensor leaf placed as ``model``'s
    parameter of that name is (a dense mask sharded like its parameter, or
    kept by its parameter's stage); other leaves (a bit-packed mask) stay
    whole."""
    params = dict(model.named_parameters())
    return {k: shard_like(v, params[k]) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def data_group(mesh):
    """The process group of the mesh's ``data`` axis, over which gradients
    and losses are averaged; None without a mesh or a ``data`` axis."""
    return _split_of(mesh).group
