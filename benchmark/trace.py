"""A profiled stretch of a cell: ``torch.profiler`` over named ranges
(``bench.<name>``) that the cell's kind (kinds/<kind>.py) opens, read
back from its Chrome trace.

What it gives the per-layer readers: for each range its span on the
host clock and the device's kernels that ran inside it (the kind ends
each range with a sync, so a range's kernels finish inside it); for the
whole stretch the device's busy time (the union of its kernels, copies
and sets), the stretch's length, and the breakdown: the device operations
that took most time, and the idle time of the device summed by what the
host was doing at the middle of each gap (the innermost host op there)."""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "bench."
TOP = 10


class Profile:
    def __init__(self, device):
        self.device = torch.device(device)
        self.result = None
        self._prof = None
        self._stretch = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._stretch = torch.profiler.record_function(PREFIX + "stretch")
        self._stretch.__enter__()
        return self

    def range(self, name):
        return torch.profiler.record_function(PREFIX + name)

    def __exit__(self, *exc):
        self._stretch.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = read(self._prof)
        return False


def read(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse([e for e in events if e.get("ph") == "X"])


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse(events):
    """The stretch's record from its complete ('X') trace events (times
    in microseconds, as the trace has them)."""
    ranges = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith(PREFIX):
            ranges[name[len(PREFIX):]] = (float(e["ts"]),
                                          float(e["ts"]) + float(e["dur"]))
    if "stretch" not in ranges:
        raise RuntimeError("the profiled stretch left no range in the trace")
    s0, s1 = ranges.pop("stretch")
    device = [(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
              for e in events if e.get("cat") in DEVICE_CATS]
    device = [d for d in device if s0 <= d[1] <= s1]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") == "cpu_op"]

    busy = _merged([(a, min(a + d, s1)) for _, a, d, _ in device])
    busy_us = sum(b - a for a, b in busy)

    per_range = {}
    for name, (a, b) in ranges.items():
        kernels = [(n, d) for n, t, d, c in device
                   if c == "kernel" and a <= t <= b]
        per_range[name] = {"start_us": a, "end_us": b, "kernels": kernels}

    totals = {}
    for name, _, d, _ in device:
        totals[name] = totals.get(name, 0.0) + d
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]

    # each idle gap named by the innermost host op running at its middle:
    # a sweep over the gaps in time order with the host ops open there
    gaps = []
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((0.5 * (a + b), b - a))
    host.sort()
    open_ops, j, idle = [], 0, {}
    for mid, length in gaps:
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(open_ops, (host[j][1], host[j][0], host[j][2]))
            j += 1
        while open_ops and open_ops[0][0] < mid:
            heapq.heappop(open_ops)
        what = (min(open_ops, key=lambda h: h[0] - h[1])[2] if open_ops
                else "python, between ops")
        idle[what] = idle.get(what, 0.0) + length
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]

    return {
        "ranges": per_range,
        "busy_s": busy_us * 1e-6,
        "window_s": (s1 - s0) * 1e-6,
        "device_events": len(device),
        "breakdown": {
            "device_ops": [[n[:160], t * 1e-6] for n, t in device_ops],
            "idle_gaps": [[n[:160], t * 1e-6] for n, t in idle_gaps],
        },
    }
