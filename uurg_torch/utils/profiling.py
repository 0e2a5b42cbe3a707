"""Profiling and timing utilities.

Port of ``uurg_tpu/utils/profiling.py``. The reference logs only
wall-clock steps/s deltas (DDPM/runners/diffusion.py:1182-1185,
DiT/forget.py:329-336). Here: :class:`StepTimer` (steps/s that waits for
the device at its window's ends only), :func:`trace` (a ``torch.profiler``
Chrome trace, for Perfetto or ``chrome://tracing``), :func:`maybe_trace`
(the CLIs' ``--profile_dir``) and :func:`timed`. Waiting for the device is
``torch.cuda.synchronize`` on each CUDA device that holds a tensor of what
is handed over (a tensor, a module's parameters, or lists, tuples and
dicts of them); CPU tensors need no wait.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def wait_for(tree) -> None:
    """Wait for the CUDA devices that hold the tensors of ``tree``."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Accurate steps/s: waits for the device at window boundaries only."""

    def __init__(self):
        self._start = None
        self._steps = 0

    def start(self, sync_on=None):
        if sync_on is not None:
            wait_for(sync_on)
        self._start = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    def rate(self, sync_on=None) -> float:
        if sync_on is not None:
            wait_for(sync_on)
        dt = time.perf_counter() - self._start
        return self._steps / dt if dt > 0 else float("inf")


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (host ops, and the card's
    kernels where there is one), written to ``<log_dir>/trace.json`` when
    the block ends, also when it raises: ``with trace('RUN/trace'):
    run_steps()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def maybe_trace(log_dir: str | None):
    """:func:`trace` when ``log_dir`` is non-empty, else nothing: the
    ``--profile_dir`` CLI hook."""
    if log_dir:
        with trace(log_dir):
            yield log_dir
    else:
        yield None


def timed(fn, *args, sync: bool = True, **kwargs):
    """(result, seconds), after waiting for the device that holds the
    result (``sync=False``: the enqueue time only)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        wait_for(out)
    return out, time.perf_counter() - t0
