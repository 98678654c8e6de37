"""Host spans and the device trace of a run's window.

``Spans`` times the benchmark's own calls into each layer of the program
(host clock), and under ``--trace 1`` also marks them in the profiler's
timeline (``record_function("fsbench.<name>")``), so each idle gap of the
device can be laid to what the host was doing.  ``reduce`` turns a
``torch.profiler`` run into kernel intervals inside the window, the union of
them (busy seconds), the longest idle gaps labelled by the innermost span
open at their midpoint, and device time by kernel name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["Spans", "Trace", "profiler", "reduce"]

PREFIX = "fsbench."
WINDOW = PREFIX + "window"


class Spans:
    """Host-clock durations (s) by span name; marked in the trace when
    ``traced``."""

    def __init__(self, traced: bool = False) -> None:
        self.traced = traced
        self.seconds: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = (torch.profiler.record_function(PREFIX + name) if self.traced
                else contextlib.nullcontext())
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


def profiler(enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


class Trace:
    """What ``reduce`` reads from a profiler run (seconds, window-relative)."""

    def __init__(self, kernels, window_s: float, spans) -> None:
        self.kernels = kernels        # [(name, start, duration)]
        self.window_s = window_s
        self.spans = spans            # [(name, start, end)]
        self.busy_s, self.gaps = _union_and_gaps(kernels, window_s)

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for name, _, dur in self.kernels:
            by[name[:96]] += dur
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        out = []
        for start, end in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (start + end)
            open_ = [(s, n) for n, s, e in self.spans if s <= mid < e]
            label = max(open_)[1] if open_ else "no span"
            out.append([label, end - start])
        return out


def _union_and_gaps(kernels, window_s: float):
    busy, gaps, cursor = 0.0, [], 0.0
    for _, start, dur in sorted(kernels, key=lambda k: k[1]):
        end = start + dur
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if window_s > cursor:
        gaps.append((cursor, window_s))
    return busy, gaps


def reduce(prof) -> Trace:
    """Kernel intervals and the benchmark's spans inside the window span,
    from the profiler's raw events (building its event tree takes minutes
    for a 30 s window of small kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.device_type() == cuda, e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    window = [(s, t) for name, on_card, s, t in events if name == WINDOW and not on_card]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans, not 1")
    (w0, w1), = window
    kernels, spans = [], []
    for name, on_card, s, t in events:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if on_card:
            # the spans' own device-side ranges are no kernels
            if not name.startswith(PREFIX):
                kernels.append((name, (s - w0) / 1e9, (t - s) / 1e9))
        elif name.startswith(PREFIX) and name != WINDOW:
            spans.append((name[len(PREFIX):], (s - w0) / 1e9, (t - w0) / 1e9))
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity in the window")
    return Trace(kernels, (w1 - w0) / 1e9, spans)
