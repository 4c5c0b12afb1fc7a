"""The traced window, reduced: the benchmark's host spans, the device's
operations by name and kind, the device's busy time and its idle gaps.

Spans are ``torch.profiler.record_function`` ranges named ``bench.<span>``
that the harness opens around its calls into the program (``window``,
``loader_wait``, ``dispatch``); they share the profiler's clock with the
device's operations.  A device operation is every event the profiler
records on the device that is not a range annotation; a runtime call is
a host event of the CUDA runtime or its lower API (``cuda*``, ``cu*``), such
as a kernel or graph launch, a copy or a synchronization.  Busy time is the
union of the operations' intervals inside the window; an idle gap is a
stretch of the window outside that union, named by the benchmark span
that was open on the host when it began (``harness``: none was).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Tuple

import numpy as np

from benchmark import kernels

SPAN_PREFIX = "bench."
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


@dataclasses.dataclass
class Trace:
    spans: Dict[str, List[Tuple[int, int]]]   # ns, on the profiler's clock
    ops: Dict[str, Tuple[int, float]]         # name -> (count, seconds)
    window_s: float
    busy_s: float
    gaps: List[Tuple[str, float]]             # the longest first
    runtime: List[Tuple[int, int, str]]       # host runtime calls, by start

    def kind_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, (_, s) in self.ops.items():
            k = kernels.kind(name)
            out[k] = out.get(k, 0.0) + s
        return out

    def span_seconds(self, name: str) -> List[float]:
        return [(b - a) / 1e9 for a, b in self.spans.get(name, [])]

    def runtime_seconds(self, name: str) -> List[Dict[str, float]]:
        """Per instance of span ``name``: seconds by runtime call inside
        it."""
        starts = [a for a, _, _ in self.runtime]
        out = []
        for a, b in self.spans.get(name, []):
            calls: Dict[str, float] = {}
            for s, e, call in self.runtime[bisect.bisect_left(starts, a):
                                           bisect.bisect_right(starts, b)]:
                calls[call] = calls.get(call, 0.0) + (min(e, b) - s) / 1e9
            out.append(calls)
        return out

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return {"device_ops": [[name[:160], s] for name, (_, s) in top],
                "idle_gaps": [[name, s] for name, s in self.gaps[:n]]}


def _is_device(evt) -> bool:
    return str(evt.device_type()).endswith("CUDA")


def reduce(prof) -> Trace:
    """A ``torch.profiler.profile`` that traced one ``bench.window``."""
    spans: Dict[str, List[Tuple[int, int]]] = {}
    names, starts, ends = [], [], []
    runtime = []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if _is_device(evt):
            if evt.is_user_annotation() or name.startswith(
                    kernels.ANNOTATIONS):
                continue
            names.append(name)
            starts.append(evt.start_ns())
            ends.append(evt.end_ns())
        elif name.startswith(SPAN_PREFIX):
            spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                (evt.start_ns(), evt.end_ns()))
        elif RUNTIME.match(name):
            runtime.append((evt.start_ns(), evt.end_ns(), name))
    (w0, w1), = spans["window"]
    start = np.clip(np.array(starts, np.int64), w0, w1)
    end = np.clip(np.array(ends, np.int64), w0, w1)
    ops: Dict[str, Tuple[int, float]] = {}
    for name, dur in zip(names, (end - start).tolist()):
        c, s = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, s + dur / 1e9)
    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    # a gap opens where an operation starts after everything before it
    # ended, and the window's tail after the last one
    reach = np.maximum.accumulate(end)
    gap_a = np.concatenate([[w0], reach])
    gap_b = np.concatenate([start, [w1]])
    length = np.maximum(gap_b - gap_a, 0)
    idle_ns = int(length.sum())
    window_ns = w1 - w0
    host = sorted((a, b, n) for n, iv in spans.items() if n != "window"
                  for a, b in iv)
    host_starts = [a for a, _, _ in host]
    gaps = []
    for i in np.argsort(-length)[:10]:
        if length[i] <= 0:
            break
        at = int(gap_a[i])
        j = bisect.bisect_right(host_starts, at) - 1
        name = host[j][2] if j >= 0 and host[j][1] > at else "harness"
        gaps.append((name, int(length[i]) / 1e9))
    return Trace(spans, ops, window_ns / 1e9, (window_ns - idle_ns) / 1e9,
                 gaps, sorted(runtime))
