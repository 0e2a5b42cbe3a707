"""Fisher-diagonal (squared-gradient) accumulation, and the gradient sums
of the SalUn mask.

Port of ``uurg_tpu/unlearn/fisher.py``. A loss function has the signature
``loss_fn(model, batch, generator) -> scalar``. Gradients are taken with
``torch.autograd.grad``, so nothing accumulates in the parameters' ``.grad``
between batches, and folded into fp32 accumulators keyed by parameter name.
One generator a call, reseeded every batch from ``(seed, batch index)``;
the JAX package splits its key once a batch, so the two streams never match
bit for bit and tests inject the draws.

The per-sample Fisher of ``sa_forget`` (``make_per_sample_fisher_step``)
takes one ``torch.autograd.grad`` an example in a loop, as the torch
reference does (one backward a sample), where the JAX package maps
``grad`` over the batch with ``vmap``: the attention and GroupNorm kernels
sit behind ``autograd.Function``s that ``torch.func`` cannot transform, and
the GroupNorm backward kernel folds dscale and dbias over the whole batch.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from uurg_torch.core.rng import step_seed

# loss_fn(model, batch, generator) -> scalar
LossFn = Callable[..., torch.Tensor]


def _grads(loss_fn: LossFn, model: torch.nn.Module, batch,
           generator: torch.Generator) -> list[torch.Tensor]:
    """d loss / d params in ``model.parameters()`` order; a parameter the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    params = list(model.parameters())
    return list(torch.autograd.grad(loss_fn(model, batch, generator), params,
                                    allow_unused=True,
                                    materialize_grads=True))


def make_fisher_batch_step(loss_fn: LossFn) -> Callable:
    """``step(fisher, model, batch, generator)``: ``fisher += (d loss /
    d params)^2`` in place.

    Squares the *batch-mean* gradient, not per-sample gradients, as the
    reference does (DDPM/runners/diffusion.py:1265-1281)."""

    def step(fisher: dict[str, torch.Tensor], model: torch.nn.Module, batch,
             generator: torch.Generator) -> None:
        acc = list(fisher.values())
        grads = [g.to(a.dtype) for g, a in
                 zip(_grads(loss_fn, model, batch, generator), acc)]
        torch._foreach_addcmul_(acc, grads, grads)

    return step


def _zeros(model: torch.nn.Module, dtype: torch.dtype) -> dict:
    return {n: torch.zeros_like(p, dtype=dtype)
            for n, p in model.named_parameters()}


def accumulate_fisher(loss_fn: LossFn, model: torch.nn.Module,
                      batches: Iterable, seed: int, *,
                      num_batches: int | None = None,
                      dtype: torch.dtype = torch.float32
                      ) -> dict[str, torch.Tensor]:
    """Average squared batch gradients over a data stream: the Fisher
    diagonal, keyed by parameter name. Stops after ``num_batches`` when
    given; divides once by the number of batches taken (the reference
    divides inside the loop: the same result). Raises ``ValueError`` on an
    empty stream."""
    step = make_fisher_batch_step(loss_fn)
    fisher = _zeros(model, dtype)
    gen = torch.Generator(device=next(model.parameters()).device)
    n = 0
    for batch in batches:
        gen.manual_seed(step_seed(seed, n))
        step(fisher, model, batch, gen)
        n += 1
        if num_batches is not None and n >= num_batches:
            break
    if n == 0:
        raise ValueError("accumulate_fisher received no batches")
    torch._foreach_mul_(list(fisher.values()), 1.0 / n)
    return fisher


def sum_gradients(loss_fn: LossFn, model: torch.nn.Module,
                  batches: Iterable, seed: int) -> dict[str, torch.Tensor]:
    """The sum over a data stream of the batch gradients, keyed by parameter
    name, in the parameters' dtype: what the SalUn top-k mask ranks
    (DDPM/runners/diffusion.py:930-1036)."""
    acc = _zeros(model, next(model.parameters()).dtype)
    gen = torch.Generator(device=next(model.parameters()).device)
    for i, batch in enumerate(batches):
        gen.manual_seed(step_seed(seed, i))
        torch._foreach_add_(list(acc.values()),
                            _grads(loss_fn, model, batch, gen))
    return acc


def make_per_sample_fisher_step(per_sample_loss_fn: LossFn) -> Callable:
    """``step(fisher, model, batch, seed)``: ``fisher += mean over the batch
    of g_i^2`` in place, ``g_i`` the gradient of ``per_sample_loss_fn(model,
    example_i, generator)`` for ONE example (DDPM/runners/diffusion.py:
    264-344, SA-FIM). ``batch`` is a tuple of tensors with a leading batch
    axis; example ``i`` is the tuple of their ``i``-th rows, and its
    generator is seeded from ``step_seed(seed, i)``."""

    def step(fisher: dict[str, torch.Tensor], model: torch.nn.Module, batch,
             seed: int) -> None:
        acc = list(fisher.values())
        n = batch[0].shape[0]
        gen = torch.Generator(device=next(model.parameters()).device)
        for i in range(n):
            gen.manual_seed(step_seed(seed, i))
            example = tuple(leaf[i] for leaf in batch)
            grads = [g.to(a.dtype) for g, a in zip(
                _grads(per_sample_loss_fn, model, example, gen), acc)]
            torch._foreach_addcmul_(acc, grads, grads, value=1.0 / n)

    return step
