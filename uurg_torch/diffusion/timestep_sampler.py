"""Timestep samplers: uniform and loss-second-moment resampling.

Port of ``uurg_tpu/diffusion/timestep_sampler.py`` (ADM's ScheduleSampler,
UniformSampler and LossSecondMomentResampler, DiT/diffusion/
timestep_sampler.py:13-150). The state is a pair of tensors, a (T, K) loss
ring buffer and the fill counts; the functions return a new state and leave
their input as it is.

- The weights are uniform until EVERY timestep holds ``history_per_term``
  losses, then sqrt(E[loss^2]) mixed with ``uniform_prob`` uniform mass.
- Importance weights are 1 / (T p[t]), so the weighted objective is an
  unbiased estimate of the uniform-t one.
- The ring-buffer update is sequential over the batch, so duplicate
  timesteps shift the buffer in order as the reference's Python loop does.
  It runs on the host (a few hundred scalar writes at most) and the new
  state goes back to the state's device.
- ``update_with_local_losses`` gathers every rank's (t, loss) pairs with
  ``torch.distributed.all_gather`` first (the reference's sync), so every
  rank applies the same global update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class LossSecondMomentState(NamedTuple):
    """A (T, K) float32 loss ring buffer and (T,) int32 fill counts."""

    history: torch.Tensor
    counts: torch.Tensor


def init_loss_second_moment(num_timesteps: int, history_per_term: int = 10,
                            device: torch.device | str = "cpu"
                            ) -> LossSecondMomentState:
    """Empty history (timestep_sampler.py:121-128 defaults)."""
    return LossSecondMomentState(
        history=torch.zeros((num_timesteps, history_per_term),
                            dtype=torch.float32, device=device),
        counts=torch.zeros((num_timesteps,), dtype=torch.int32,
                           device=device))


def sampler_weights(state: LossSecondMomentState,
                    uniform_prob: float = 0.001) -> torch.Tensor:
    """The sampling distribution over timesteps: uniform until warmed up,
    then sqrt(mean(history^2)) renormalised and mixed with
    ``uniform_prob`` uniform mass (timestep_sampler.py:130-137)."""
    T, K = state.history.shape
    if not bool((state.counts >= K).all()):
        return torch.full((T,), 1.0 / T, device=state.history.device)
    w = torch.sqrt(torch.mean(torch.square(state.history), dim=-1))
    w = w / torch.clamp(w.sum(), min=1e-12)
    return w * (1.0 - uniform_prob) + uniform_prob / T


def sample_timesteps(state: LossSecondMomentState,
                     generator: torch.Generator, batch: int,
                     uniform_prob: float = 0.001
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t, w)``: a batch of timesteps drawn from :func:`sampler_weights`
    and their importance weights ``1 / (T p[t])``
    (timestep_sampler.py:44-59)."""
    p = sampler_weights(state, uniform_prob)
    t = torch.multinomial(p, batch, replacement=True, generator=generator)
    return t, 1.0 / (p.shape[0] * p[t])


def update_with_all_losses(state: LossSecondMomentState, t: torch.Tensor,
                           losses: torch.Tensor) -> LossSecondMomentState:
    """Fold a (global) batch of per-sample losses into the ring buffer, in
    batch order (timestep_sampler.py:139-147)."""
    hist = state.history.detach().cpu().clone()
    counts = state.counts.detach().cpu().clone()
    K = hist.shape[1]
    for ti, li in zip(t.detach().cpu().tolist(),
                      losses.detach().float().cpu().tolist()):
        if counts[ti] >= K:
            hist[ti] = torch.roll(hist[ti], -1)
            hist[ti, K - 1] = li
        else:
            hist[ti, counts[ti]] = li
            counts[ti] += 1
    dev = state.history.device
    return LossSecondMomentState(hist.to(dev), counts.to(dev))


def update_with_local_losses(state: LossSecondMomentState, t: torch.Tensor,
                             losses: torch.Tensor,
                             group=None) -> LossSecondMomentState:
    """Gather every rank's batch of ``(t, loss)`` over ``group`` (the
    default process group when None; it must be initialised), then apply
    the global update on every rank (timestep_sampler.py:72-103). Every
    rank must pass the same batch size."""
    if not dist.is_initialized():
        raise RuntimeError("update_with_local_losses needs an initialised "
                           "torch.distributed process group; use "
                           "update_with_all_losses on one process")
    n = dist.get_world_size(group)
    t_all = [torch.empty_like(t) for _ in range(n)]
    l_all = [torch.empty_like(losses) for _ in range(n)]
    dist.all_gather(t_all, t.contiguous(), group=group)
    dist.all_gather(l_all, losses.contiguous(), group=group)
    return update_with_all_losses(state, torch.cat(t_all), torch.cat(l_all))


def uniform_timesteps(generator: torch.Generator, batch: int,
                      num_timesteps: int, device: torch.device | str = "cpu"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """UniformSampler (timestep_sampler.py:62-68): every weight is 1."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator,
                      device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)
