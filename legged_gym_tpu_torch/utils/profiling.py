"""Profiling and throughput metering (the reference has none; its only
performance tool is pressing 'v' to stop rendering).

- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (chrome://tracing, Perfetto) of what ran inside it
  into ``log_dir``; it traces the card too when one is present;
- ``Meter``: an exponential moving average of steps/s, ticked by the
  caller's loop (the JAX package's ``Meter``, line for line).
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block and write ``<log_dir>/trace_<pid>.json``, the
    card's activity included when torch sees a card. Yields the profiler
    (its ``key_averages()`` sums by op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class Meter:
    """Exponential-moving-average steps/s meter."""

    def __init__(self, alpha=0.2):
        self.alpha = alpha
        self.rate = None
        self._t = None

    def tick(self, steps):
        now = time.perf_counter()
        if self._t is not None:
            r = steps / (now - self._t)
            self.rate = r if self.rate is None else \
                (1 - self.alpha) * self.rate + self.alpha * r
        self._t = now
        return self.rate
