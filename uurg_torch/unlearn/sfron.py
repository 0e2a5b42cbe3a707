"""SFR-on: the fast-slow two-phase unlearning step.

Port of ``uurg_tpu/unlearn/sfron.py``. Per iteration:

  [every forget_freq steps]  FORGET: grads of alpha(step) * forget_loss,
                             multiplied by the saliency mask, clipped,
                             applied through the shared optimizer
  [every step]               REMAIN: grads of remain_alpha * remain_loss,
                             optionally clipped, applied
  [every step]               EMA shadow update and/or fast-slow mixing

``method="joint"`` (the paper's ablation) combines both losses into one
masked update per step, masking the combined gradient as the JAX package
does.

Where the JAX step is one jitted pure function of a state pytree, this one
runs eagerly and updates the state's model, optimizer and EMA model in
place. Gradients are the parameters' ``.grad`` tensors: every parameter
holds one from :func:`init_state` on, zeroed before each phase, so that
``torch.optim`` (which skips a parameter whose ``.grad`` is None, where
optax updates every leaf) ticks every Adam moment on every phase, for
example ``null_classes_emb`` when a batch keeps every label. One optimizer
serves both phases, so Adam's step count rises twice per iteration. The
weighted gradient of a phase is taken as the gradient of the loss times its
weight (alpha, remain_alpha, 1/grad_accum), which equals the JAX package's
scaled gradient in exact arithmetic.

Mutable model state (BatchNorm running statistics, the JAX
``has_model_state``) lives in the model's buffers: a loss function that
runs the model in train mode moves them in place, so the forget phase moves
them only on the steps where it runs and the remain phase then moves them
again, as the JAX step threads them through its ``lax.cond``. The fast-slow
mix touches parameters only.

Under data parallel every rank runs the step on its rows of the global
batch and, after each phase's backward and before the mask, the gradients
are averaged over the state's ``group`` in one flat all-reduce (the twin of
the loss-mean psum that pjit inserts), the phase's loss with them. Under
FSDP the sharded parameters' gradients come reduced from FSDP2's reduce-
scatter and only the whole ones are averaged here; under tensor parallel
every rank of the ``model`` axis holds the gradient of its shards (and the
same whole gradients), which are averaged over the ``data`` group alone
(the state's ``group``); the mask, the clip and the EMA then run shard by
shard, the clip's norm summing each shard once.

:func:`make_sfron_scan` runs ``chunk`` steps a call, on one device: on the
card one replay of a CUDA graph of the chunk's steps (the twin of the JAX
package's ``lax.scan`` in one dispatch, for a host that cannot launch a
step as fast as the card runs it), beside the chunk's plain eager loop,
which the CPU runs. Its steps read alpha and the learning rate from a
table on the device and take a capture-safe optimizer
(``make_optimizer(..., capturable=True)``). The classification method
takes it with its splits on the device
(:func:`uurg_torch.unlearn.methods.classification.device_batcher`).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch

from uurg_torch.core import tree as tr
from uurg_torch.core.rng import step_seed
from uurg_torch.diffusion.losses import cosine_alpha_decay, linear_alpha_decay
from uurg_torch.parallel.mesh import (all_reduce_mean_, is_sharded, is_tp,
                                      local, zeros_like)
from uurg_torch.train.optim import is_capturable, set_lr
from uurg_torch.unlearn.ema import ema_update, fast_slow_mix

# loss_fn(model, batch, generator) -> scalar loss to MINIMIZE. Gradient-
# ascent methods pass a loss that is already negated.
LossFn = Callable[[torch.nn.Module, tuple, torch.Generator], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SFRonConfig:
    n_iters: int
    forget_alpha: float
    remain_alpha: float = 1.0
    alpha_sched: str = "cosine"        # cosine | linear | expdecay | const
    forget_freq: int = 1               # forget step every N iters (cls: 5)
    forget_clip: Optional[float] = 1.0
    remain_clip: Optional[float] = 1.0  # None = no clip (classification)
    method: str = "ron"                # ron | joint
    ema_mu: Optional[float] = None     # DDPM/DiT shadow-EMA rate
    fast_slow_beta: Optional[float] = None  # classification mixing beta
    grad_accum: int = 1                # microbatches accumulated per update


@dataclasses.dataclass
class SFRonState:
    """The model being unlearned, its optimizer, the EMA shadow model (or
    None), the step count and the saliency mask (``dict[str, Tensor]`` of
    0/1 or bool tensors or :class:`~uurg_torch.core.tree.PackedMask`, keyed
    by parameter name, or None) and the process group over which the
    gradients and losses are averaged (None on one device)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_model: Optional[torch.nn.Module] = None
    step: int = 0
    mask: Optional[dict] = None
    group: Any = None


def init_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               ema: bool = False, mask: Optional[dict] = None,
               ema_model: Optional[torch.nn.Module] = None,
               group: Any = None) -> SFRonState:
    """Give every parameter a zero ``.grad`` and, with ``ema``, copy the
    model into a frozen shadow in eval mode (it is sampled, never
    trained). A sharded model's shadow is made before sharding and passed
    as ``ema_model``, sharded as the model is."""
    names = [n for n, _ in model.named_parameters()]
    if mask is not None and set(mask) != set(names):
        raise ValueError("the mask's keys must be the model's parameter "
                         "names")
    if ema and ema_model is None:
        ema_model = make_shadow(model)
    for p in model.parameters():
        p.grad = zeros_like(p)
    return SFRonState(model=model, optimizer=optimizer, ema_model=ema_model,
                      mask=mask, group=group)


def make_shadow(model: torch.nn.Module) -> torch.nn.Module:
    """A frozen copy of ``model`` in eval mode, without gradients: the EMA
    shadow."""
    shadow = copy.deepcopy(model).requires_grad_(False).eval()
    for p in shadow.parameters():
        p.grad = None
    return shadow


def _alpha_at(cfg: SFRonConfig, step: int) -> float:
    if cfg.alpha_sched == "cosine":
        return cosine_alpha_decay(cfg.forget_alpha, step, cfg.n_iters)
    if cfg.alpha_sched == "linear":
        return linear_alpha_decay(cfg.forget_alpha, step, cfg.n_iters, 1.0)
    if cfg.alpha_sched == "expdecay":
        return linear_alpha_decay(cfg.forget_alpha, step, cfg.n_iters, 2.0)
    if cfg.alpha_sched == "const":
        return float(cfg.forget_alpha)
    raise NotImplementedError(cfg.alpha_sched)


def _forget_off(cfg: SFRonConfig) -> bool:
    """Statically disabled forgetting (pretrain/retrain reuse this engine):
    the phase is skipped, not fed zero gradients, which would still tick
    Adam's count and decay its moments (a phantom update per step against
    the reference's single optimizer.step(), DDPM/runners/diffusion.py
    :138-158)."""
    return (cfg.method == "ron" and cfg.alpha_sched == "const"
            and cfg.forget_alpha == 0.0)


def _forgets(cfg: SFRonConfig, step: int) -> bool:
    """Whether the forget phase runs at ``step`` (``method="ron"``)."""
    return not _forget_off(cfg) and step % cfg.forget_freq == 0


def _make_body(cfg: SFRonConfig, forget_loss_fn: Optional[LossFn],
               remain_loss_fn: LossFn):
    """``body(state, forget_batch, remain_batch, generator, forget_weight,
    forget) -> (forget_loss, remain_loss, remain_grad_norm)``: one
    iteration's phases at the optimizer's current learning rate, with no
    read of ``state.step``. ``forget_weight`` is alpha / grad_accum, a
    float or a 0-d float32 tensor (equal bits either way: the loss is
    float32); ``forget`` whether the forget phase runs (``method="ron"``)."""
    if cfg.method not in ("ron", "joint"):
        raise NotImplementedError(cfg.method)
    if forget_loss_fn is None and not _forget_off(cfg):
        raise ValueError("forget_loss_fn is needed unless forgetting is off")
    n_accum = max(int(cfg.grad_accum), 1)
    remain_weight = cfg.remain_alpha / n_accum

    def body(state: SFRonState, forget_batch, remain_batch,
             generator: torch.Generator, forget_weight, forget: bool):
        model, opt = state.model, state.optimizer
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        if any(g is None for g in grads.values()):
            raise ValueError("every parameter needs a .grad tensor: build the "
                             "state with init_state")
        prev = None
        if cfg.fast_slow_beta is not None and cfg.fast_slow_beta != 1.0:
            prev = [p.detach().clone() for p in params.values()]

        def accumulate(loss_fn, batch, weight) -> torch.Tensor:
            """Add weight * (the microbatch sum of d loss / d params) into
            .grad; return the mean loss."""
            mbs = [batch] if n_accum == 1 else [
                tuple(leaf[i] for leaf in batch) for i in range(n_accum)]
            total = 0.0
            for mb in mbs:
                loss = loss_fn(model, mb, generator)
                (loss * weight).backward()
                total = total + loss.detach().float()
            return total / n_accum

        def zero_grads():
            torch._foreach_zero_([local(g) for g in grads.values()])

        whole = [local(grads[k]) for k, p in params.items()
                 if not is_sharded(p) or is_tp(p)]

        def reduce(*losses: torch.Tensor) -> list[torch.Tensor]:
            """Average the gradients FSDP does not reduce (the whole and
            the tensor-parallel ones) and the losses over the group, in
            one flat all-reduce."""
            if state.group is None:
                return list(losses)
            flat = torch.stack(losses).float()
            all_reduce_mean_(whole + [flat], state.group)
            return list(flat.unbind())

        def apply(clip) -> torch.Tensor:
            if clip is not None:
                norm = tr.clip_by_global_norm_(grads, clip)
            else:
                norm = tr.global_norm(grads)
            opt.step()
            return norm

        dev = next(iter(params.values())).device
        forget_loss = torch.zeros((), device=dev)
        if cfg.method == "ron":
            if forget:
                zero_grads()
                forget_loss, = reduce(accumulate(forget_loss_fn,
                                                 forget_batch, forget_weight))
                if state.mask is not None:
                    tr.tree_mul_(grads, state.mask)
                apply(cfg.forget_clip)
            zero_grads()
            remain_loss, = reduce(accumulate(remain_loss_fn, remain_batch,
                                             remain_weight))
            rnorm = apply(cfg.remain_clip)
        else:
            # joint: one update from the combined gradient at the same
            # params, masked as a whole
            zero_grads()
            forget_loss = accumulate(forget_loss_fn, forget_batch,
                                     forget_weight)
            remain_loss = accumulate(remain_loss_fn, remain_batch,
                                     remain_weight)
            forget_loss, remain_loss = reduce(forget_loss, remain_loss)
            if state.mask is not None:
                tr.tree_mul_(grads, state.mask)
            rnorm = apply(cfg.remain_clip)

        if prev is not None:
            fast_slow_mix(params.values(), prev, cfg.fast_slow_beta)
        if state.ema_model is not None:
            ema_update(state.ema_model.parameters(), params.values(),
                       cfg.ema_mu)
        return forget_loss, remain_loss, rnorm

    return body


def make_sfron_step(cfg: SFRonConfig, forget_loss_fn: Optional[LossFn],
                    remain_loss_fn: LossFn,
                    lr_schedule: Callable | None = None):
    """Build ``step_fn(state, forget_batch, remain_batch, generator) ->
    metrics``, which advances ``state`` in place. Batches are tuples of
    tensors; with ``grad_accum > 1`` each leaf carries a leading
    [grad_accum] axis (see :func:`stack_microbatches`). ``lr_schedule``
    (step -> lr) sets the learning rate before each step. ``forget_loss_fn``
    may be None when forgetting is statically off (``alpha_sched="const"``,
    ``forget_alpha=0``, ``method="ron"``)."""
    body = _make_body(cfg, forget_loss_fn, remain_loss_fn)
    n_accum = max(int(cfg.grad_accum), 1)

    def step_fn(state: SFRonState, forget_batch, remain_batch,
                generator: torch.Generator) -> dict:
        cur_alpha = _alpha_at(cfg, state.step)
        if lr_schedule is not None:
            set_lr(state.optimizer, lr_schedule(state.step))
        forget_loss, remain_loss, rnorm = body(
            state, forget_batch, remain_batch, generator,
            cur_alpha / n_accum, _forgets(cfg, state.step))
        state.step += 1
        return {"forget_loss": forget_loss, "remain_loss": remain_loss,
                "forget_alpha": cur_alpha, "remain_grad_norm": rnorm}

    return step_fn


def stack_microbatches(batches: Iterable, n: int):
    """Wrap a batch iterator for ``SFRonConfig.grad_accum=n``: each yield
    stacks ``n`` consecutive batches (tuples of tensors) along a new leading
    axis. A finite iterator's ragged tail is dropped."""
    batches = iter(batches)
    if n <= 1:
        yield from batches
        return
    while True:
        group = []
        for _ in range(n):
            try:
                group.append(next(batches))
            except StopIteration:
                return
        yield tuple(torch.stack(leaves) for leaves in zip(*group))


class SFRonScan:
    """``chunk`` SFR-on iterations a call: the twin of the JAX package's
    ``lax.scan`` of steps in one dispatch, built by :func:`make_sfron_scan`.

    ``scan(state, f, r, generator) -> metrics`` advances ``state`` by
    ``chunk`` steps; every metric is a (chunk,) tensor, as the scan's
    stacked metrics are. Each iteration does what :func:`make_sfron_step`
    does at its step, with alpha, alpha / grad_accum and the learning rate
    read from a float32 table on the device (the values the step would
    compute on the host, rounded alike) and the forget pattern of the
    chunk's steps fixed when it is built.

    On the CPU a call runs :meth:`plain`, the chunk's eager loop. On CUDA
    the first call runs :meth:`plain` on a side stream as the warm-up: its
    steps are real and create the optimizer's state. A later call replays a
    ``torch.cuda.CUDAGraph`` of the chunk, captured at the first call of
    each forget pattern (one when ``forget_freq`` divides ``chunk``; one a
    value of ``start % forget_freq`` otherwise), after the chunk's table
    rows (and, given batches, the batches) are copied into the graph's
    static buffers. A graph is bound to the state, generator and resident
    data of its capture; a call with others raises, and so does a failed
    capture: nothing falls back to eager steps. ``replays`` counts the
    replays of each pattern (a tuple of the chunk's forget flags)."""

    def __init__(self, cfg: SFRonConfig, forget_loss_fn: Optional[LossFn],
                 remain_loss_fn: LossFn, chunk: int, device_batcher=None,
                 lr_schedule: Callable | None = None, seed: int = 0):
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.cfg, self.chunk = cfg, int(chunk)
        self.batcher, self.lr_schedule, self.seed = (device_batcher,
                                                     lr_schedule, seed)
        self.n_accum = max(int(cfg.grad_accum), 1)
        if device_batcher is not None and self.n_accum > 1:
            raise ValueError("the resident mode draws one batch a phase: "
                             "grad_accum must be 1")
        self._body = _make_body(cfg, forget_loss_fn, remain_loss_fn)
        self._table: torch.Tensor | None = None
        self._bound: tuple | None = None   # _key of the warm-up call
        self._graphs: dict = {}
        self.replays: dict = {}

    def _check(self, state: SFRonState) -> torch.device:
        if state.group is not None:
            raise ValueError("the scan runs on one device: a state with a "
                             "process group takes make_sfron_step")
        if not is_capturable(state.optimizer):
            raise ValueError(
                f"{type(state.optimizer).__name__} cannot be captured in a "
                f"CUDA graph (OptaxAdam and torch.optim's optimizers read "
                f"their step count or learning rate on the host): build it "
                f"with make_optimizer(..., capturable=True)")
        return next(state.model.parameters()).device

    def _pattern(self, start: int) -> tuple:
        if self.cfg.method != "ron":
            return (False,) * self.chunk
        return tuple(_forgets(self.cfg, start + k) for k in range(self.chunk))

    def _rows(self, state: SFRonState, dev: torch.device) -> torch.Tensor:
        """(3, chunk) float32 on ``dev``: alpha, alpha / grad_accum and the
        learning rate of the chunk's steps (a view of the table, which
        grows to twice its length when a chunk runs past its end)."""
        start, end = state.step, state.step + self.chunk
        if self._table is None or self._table.shape[1] < end \
                or self._table.device != dev:
            n = max(end, self.cfg.n_iters,
                    2 * (0 if self._table is None else self._table.shape[1]))
            alpha = [_alpha_at(self.cfg, s) for s in range(n)]
            lr = [self.lr_schedule(s) if self.lr_schedule else 0.0
                  for s in range(n)]
            self._table = torch.tensor(
                [alpha, [a / self.n_accum for a in alpha], lr],
                dtype=torch.float64).float().to(dev)
        return self._table[:, start:end]

    def _loop(self, state: SFRonState, f, r, generator, rows,
              pattern: tuple) -> torch.Tensor:
        """The chunk's iterations; (3, chunk): forget loss, remain loss,
        remain gradient norm."""
        out = []
        for k in range(self.chunk):
            if self.lr_schedule is not None:
                set_lr(state.optimizer, rows[2, k])
            if self.batcher is not None:
                fb = self.batcher(f, generator)
                rb = self.batcher(r, generator)
            else:
                fb = tuple(x[k] for x in f)
                rb = tuple(x[k] for x in r)
            out.append(self._body(state, fb, rb, generator, rows[1, k],
                                  pattern[k]))
        return torch.stack([torch.stack(v) for v in zip(*out)])

    def _metrics(self, state: SFRonState, rows, out) -> dict:
        state.step += self.chunk
        return {"forget_loss": out[0], "remain_loss": out[1],
                "forget_alpha": rows[0].clone(), "remain_grad_norm": out[2]}

    def plain(self, state: SFRonState, f, r,
              generator: torch.Generator) -> dict:
        """The chunk's iterations as an eager loop: the graph's plain
        version, and the CPU's path."""
        dev = self._check(state)
        rows = self._rows(state, dev)
        if self.batcher is not None:
            generator.manual_seed(step_seed(self.seed, state.step))
        return self._metrics(state, rows, self._loop(
            state, f, r, generator, rows, self._pattern(state.step)))

    def _key(self, state, f, r, generator) -> tuple:
        """What the graphs are captured on: the state's model and
        optimizer, the generator (equal only to themselves, and kept alive
        by the key) and, in the resident mode, the data's addresses."""
        data = (tuple(t.data_ptr() for d in (f, r) for t in d)
                if self.batcher is not None else ())
        return (state.model, state.optimizer, generator, data)

    def __call__(self, state: SFRonState, f, r,
                 generator: torch.Generator) -> dict:
        dev = self._check(state)
        if dev.type != "cuda":
            return self.plain(state, f, r, generator)
        main = torch.cuda.current_stream(dev)
        if self._bound is None:
            self._bound = self._key(state, f, r, generator)
            self._data = (f, r) if self.batcher is not None else None
            self._stream = torch.cuda.Stream(dev)
            self._static = torch.empty((3, self.chunk), dtype=torch.float32,
                                       device=dev)
            self._inputs = (None if self.batcher is not None else
                            tuple(tuple(x.clone() for x in d)
                                  for d in (f, r)))
            self._pool = torch.cuda.graph_pool_handle()
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                out = self.plain(state, f, r, generator)
            main.wait_stream(self._stream)
            return out
        if self._key(state, f, r, generator) != self._bound:
            raise ValueError("a scan's graphs are bound to the state, "
                             "generator and resident data of their capture")
        pattern = self._pattern(state.step)
        rows = self._rows(state, dev)
        self._static.copy_(rows)
        if self._inputs is not None:
            for dst, src in zip(self._inputs, (f, r)):
                if [x.shape for x in dst] != [x.shape for x in src]:
                    raise ValueError("a chunk's batches must keep the "
                                     "shapes of the captured chunk")
                for x, y in zip(dst, src):
                    x.copy_(y)
        if pattern not in self._graphs:
            self._graphs[pattern] = self._capture(state, generator, pattern)
        if self.batcher is not None:
            generator.manual_seed(step_seed(self.seed, state.step))
        graph, out = self._graphs[pattern]
        graph.replay()
        self.replays[pattern] = self.replays.get(pattern, 0) + 1
        return self._metrics(state, rows, out.clone())

    def _capture(self, state: SFRonState, generator, pattern: tuple):
        """(graph, its output) of the chunk's loop under ``pattern``; the
        graph's temporaries in the scan's one memory pool."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        f, r = self._data if self._inputs is None else self._inputs
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = self._loop(state, f, r, generator, self._static, pattern)
        return graph, out


def make_sfron_scan(cfg: SFRonConfig, forget_loss_fn: Optional[LossFn],
                    remain_loss_fn: LossFn, chunk: int,
                    device_batcher=None, lr_schedule: Callable | None = None,
                    seed: int = 0) -> SFRonScan:
    """Chunked SFR-on: ``chunk`` two-phase steps a call, one CUDA graph
    replay on the card (:class:`SFRonScan`). The optimizer is the state's,
    built capture-safe (``make_optimizer(..., capturable=True)``); a state
    with a process group raises. Two modes, as the JAX package's:

    - ``device_batcher=None``: ``scan(state, f_chunk, r_chunk,
      generator)`` takes batches stacked along a leading ``chunk`` axis;
      each step does exactly what :func:`make_sfron_step` does, so the
      result equals ``chunk`` calls of it (the generator handed to every
      step as it is).
    - ``device_batcher=draw``: ``scan(state, f_data, r_data, generator)``
      takes the whole splits on the device; the generator is seeded once
      a chunk from ``step_seed(seed, state.step)`` and every step draws its
      forget batch, then its remain batch, with ``draw(data, generator)``.
      The JAX package's resident stream differs from its per-step one too.
    """
    return SFRonScan(cfg, forget_loss_fn, remain_loss_fn, chunk,
                     device_batcher, lr_schedule, seed)
