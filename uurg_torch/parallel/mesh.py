"""Device meshes, batch splits and FSDP placement on ``torch.distributed``.

Port of the data-parallel and FSDP half of ``uurg_tpu/parallel/mesh.py``.
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

Tensor parallelism (the JAX module's second half) is not ported yet
(ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import warnings
from typing import Any, Iterable, Mapping

import torch
import torch.distributed as dist

from uurg_torch.parallel.dist import initialize_single, is_initialized

DATA = "data"


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


def local_slice(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of the whole tensor ``full`` that this rank holds of the
    DTensor ``like`` (``full`` when ``like`` is whole). No communication."""
    if not is_sharded(like):
        return full
    mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
    out = full
    for i, placement in enumerate(like.placements):
        if placement.is_shard():
            out = out.chunk(mesh.size(i), dim=placement.dim)[coord[i]]
    return out


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` placed as the DTensor ``like`` is (its mesh and placements,
    this rank's slice, no communication); ``full`` when ``like`` is
    whole."""
    if not is_sharded(like):
        return full
    from torch.distributed.tensor import DTensor

    part = local_slice(full, like).to(local(like).device).contiguous()
    return DTensor.from_local(part, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank of its mesh
    calls it), any other tensor itself."""
    return t.full_tensor() if is_sharded(t) else t


def full_state_dict(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``module.state_dict()`` with whole tensors on the CPU (a collective
    under FSDP)."""
    return {k: full_tensor(v.detach()).cpu()
            for k, v in module.state_dict().items()}


def full_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with whole tensors on the CPU (a collective
    under FSDP)."""
    sd = opt.state_dict()
    sd["state"] = {i: {k: full_tensor(v).cpu() if torch.is_tensor(v) else v
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
            if torch.is_tensor(v) and v.shape == params[i].shape else v
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
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    resolved = _resolve_axis(mesh, axis)
    if resolved is None:
        return model
    specs = fsdp_param_specs(model, mesh, axis, min_size)
    dim = {id(p): specs[n] for n, p in model.named_parameters()}
    ignored = {p for n, p in model.named_parameters() if specs[n] is None}
    shape = mesh_shape(mesh)
    if resolved != DATA and DATA in shape:
        sub = mesh[(DATA, resolved)]
    else:
        sub = mesh[resolved]
    kw = dict(mesh=sub, shard_placement_fn=lambda p: Shard(dim[id(p)]),
              ignored_params=ignored)
    for block in _blocks(model):
        if any(p not in ignored for p in block.parameters()):
            fully_shard(block, **kw)
    fully_shard(model, **kw)
    return model


def place_model(model: torch.nn.Module, mesh,
                parallelism: str = "dp") -> torch.nn.Module:
    """A model on ``mesh`` for ``parallelism``: its weights broadcast from
    rank 0, then, under ``fsdp``, sharded (:func:`shard_params_fsdp` over
    the ``model`` axis, or the largest). Returns ``model``; nothing happens
    without a mesh."""
    if mesh is None:
        return model
    replicate(model)
    if parallelism == "fsdp":
        shard_params_fsdp(model, mesh)
    return model


def place_like(tree: Mapping, model: torch.nn.Module) -> dict:
    """``{name: leaf}`` with each tensor leaf placed as ``model``'s
    parameter of that name is (a dense mask sharded like its parameter);
    other leaves (a bit-packed mask) stay whole."""
    params = dict(model.named_parameters())
    return {k: shard_like(v, params[k]) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def data_group(mesh):
    """The process group of the mesh's ``data`` axis, over which gradients
    and losses are averaged; None without a mesh or a ``data`` axis."""
    return _split_of(mesh).group
