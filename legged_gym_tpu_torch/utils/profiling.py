"""Profiling: named spans inside the env step, the physics wrapper and the
PPO loop, and a Chrome trace (the reference has none; its only
performance tool is pressing 'v' to stop rendering).

- ``span(name)``: a context manager around one part of the program. When
  nothing records it is a shared no-op context, entered for the cost of
  one flag check. Inside ``recording()`` it appends ``(name, start_ns,
  end_ns, parent)`` to that recording (``time.perf_counter_ns``; the
  parent is the index of the span open around it, or None). While a
  ``torch.profiler`` profile is recording, whoever opened it, it also
  opens ``torch.profiler.record_function(name)``, so the span sits in the
  profile's trace on the timeline of the kernels it launched.
- ``recording()``: records the spans opened inside it, in memory;
  ``summary()`` gives per name the count, total and self seconds.
- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace of what ran inside it, the spans included.

The open recording is the process's, as the profiler's state is: the
spans sit in code (the env step, the kernel wrapper) that no recorder is
passed to.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NOOP = contextlib.nullcontext()
_recording = None            # the open Recording, or None


class Recording:
    """The spans opened while it was the open recording, in the order they
    opened: ``spans[i] = (name, start_ns, end_ns, parent)``, ``parent``
    the index of the span open around span i (None at the top)."""

    def __init__(self):
        self.spans = []
        self._open = []

    def _enter(self, name):
        i = len(self.spans)
        self.spans.append((name, time.perf_counter_ns(), None,
                           self._open[-1] if self._open else None))
        self._open.append(i)
        return i

    def _exit(self, i):
        end = time.perf_counter_ns()
        name, start, _, parent = self.spans[i]
        self.spans[i] = (name, start, end, parent)
        self._open.pop()

    def summary(self):
        """``{name: {"n", "total_s", "self_s"}}`` over the closed spans:
        a span's self time is its total less the time its child spans
        cover."""
        children = [0] * len(self.spans)
        for _, start, end, parent in self.spans:
            if parent is not None and end is not None:
                children[parent] += end - start
        sums = {}
        for (name, start, end, _), inner in zip(self.spans, children):
            if end is None:
                continue
            s = sums.setdefault(name, [0, 0, 0])
            s[0] += 1
            s[1] += end - start
            s[2] += end - start - inner
        return {name: {"n": n, "total_s": 1e-9 * total,
                       "self_s": 1e-9 * own}
                for name, (n, total, own) in sums.items()}


class _Span:
    __slots__ = ("name", "rec", "index", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = _recording
        if self.rec is not None:
            self.index = self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec._exit(self.index)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name):
    """A context manager around one part of the program, named ``name``:
    recorded by the open ``recording()`` and shown as a range in a
    ``torch.profiler`` profile that is recording; else a no-op."""
    if _recording is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record the spans opened in the block; yields the ``Recording``. A
    recording opened inside another takes the spans until it closes."""
    global _recording
    outer, rec = _recording, Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block and write ``<log_dir>/trace_<pid>.json``, the
    card's activity included when torch sees a card, with the port's spans
    (``env.*``, ``terrain.refresh``, ``actuator.sea``,
    ``kernel.chain_step``, ``ppo.*``) as ranges around the ops and kernel
    launches they issued. Yields the profiler (its ``key_averages()`` sums
    by op)."""
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
