"""The port's tracing: host spans, counters and device-timed phase marks
of the training dispatch, recorded in memory while a ``torch.profiler``
runs on the dispatching thread, and nothing otherwise.

- The switch.  ``refresh()``, which ``MultiStep`` calls once per call on
  the thread that dispatches, reads ``torch.autograd._profiler_enabled()``
  into a module flag that every thread reads: the profiler is
  thread-local, so the loader's thread cannot ask it.  A period opens when
  the flag turns on (its spans, phase totals and counters start empty) and
  closes at the first ``refresh()`` or ``snapshot()`` that finds the
  profiler stopped.  The period ends at the last time the dispatching
  thread saw the profiler running, and what another thread recorded after
  that is left out.
- ``span(name, item=None)`` is a context manager.  When the flag is off it
  is one shared no-op (``NOOP``), allocates nothing and opens no profiler
  range.  When on, it records ``(name, thread, start_ns, end_ns, parent,
  item)``: ``parent`` is the id of the enclosing span on the same thread,
  ``item`` the loader group the work belongs to (by default the thread's
  current one, ``set_item``), so a group's placement on the loader thread
  and the dispatch that consumes it join.  On a thread the profiler traces
  it also opens the range ``medvill.<name>``, on the profiler's clock
  beside the device's operations.
- ``count(name, n=1)`` adds to a counter of the period.
- ``mark(name)`` marks a phase on the device: inside ``capture()`` and a
  CUDA-graph capture it records a timing event (``external``: an
  event-record node of the graph), and does nothing elsewhere or on the
  CPU.  ``capture()`` collects a captured graph's ``Marks``, ``bind`` finds
  their nodes in the graph (the CUDA driver's graph calls, through
  ``ctypes``).  ``replay(marks, apply)``, called just before the graph is
  replayed while the flag is on, points those nodes at a set of events of
  the replay's own (``RING`` sets in turn), so the host never waits for a
  replay to read it: a set is read when its turn comes again, ``RING``
  replays later, or by ``snapshot()``.  A read adds the time between
  consecutive marks to the phase the later one closes (``PHASES``; ``end``
  closes ``update`` on a graph that applies the optimizer update and
  ``tail`` on one that only accumulates), and ``start`` to ``end`` to
  ``replay``.
- ``snapshot()`` reads the marks still pending (its caller has synchronized
  the device) and returns the period's spans, phase totals (milliseconds
  and replays) and counters as plain data.
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch

# a span's profiler range: ``PREFIX + name``
PREFIX = "medvill."
# the phase each mark closes; ``end`` closes ``update`` or ``tail``
PHASES = {"image": "image", "forward": "forward", "backward": "backward"}
# the spans a period keeps; those past it are counted as dropped
MAX_SPANS = 1 << 17
# the event sets a graph's live replays record their marks into, in turn
RING = 16
# CU_GRAPH_NODE_TYPE_EVENT_RECORD
EVENT_RECORD_NODE = 7
NOOP = contextlib.nullcontext()
_DRIVER = None


class _State:
    def __init__(self):
        self.live = False
        self.dispatcher: Optional[int] = None   # the thread that refreshes
        self.start_ns = self.seen_ns = 0
        self.spans: List[tuple] = []
        self.dropped = 0
        self.phases: Dict[str, List[float]] = {}   # name -> [ms, replays]
        self.counters: Dict[str, int] = {}
        # (graph's marks, ring slot) -> (names, events, applies the update)
        self.pending: Dict[Tuple[int, int], tuple] = {}
        self.capturing: Optional["Marks"] = None
        self.lock = threading.Lock()


_state = _State()
_local = threading.local()
_ids = itertools.count(1)
_items = itertools.count(1)


def refresh() -> None:
    """Sets the flag from the profiler of the calling (dispatching)
    thread, opening or closing a period."""
    on = torch.autograd._profiler_enabled()
    if on and not _state.live:
        _open()
    elif not on and _state.live:
        _close()
    if on:
        _state.seen_ns = time.perf_counter_ns()


def _open() -> None:
    s = _state
    s.spans, s.dropped, s.phases, s.counters = [], 0, {}, {}
    s.pending = {}
    s.dispatcher = threading.get_ident()
    s.start_ns = s.seen_ns = time.perf_counter_ns()
    s.live = True


def _close() -> None:
    _drain()
    _state.live = False


def new_item() -> int:
    """A fresh id for a loader group."""
    return next(_items)


def set_item(item: Optional[int]) -> None:
    """The calling thread's current loader group: the default ``item`` of
    its spans."""
    _local.item = item


class _Span:
    __slots__ = ("name", "item", "traced", "id", "parent", "start", "range")

    def __init__(self, name: str, item: Optional[int], traced: bool):
        self.name, self.item, self.traced = name, item, traced

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.range = None
        if self.traced:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        s = _state
        if len(s.spans) < MAX_SPANS:
            s.spans.append((self.id, self.name,
                            threading.current_thread().name, self.start,
                            end, self.parent, self.item))
        else:
            s.dropped += 1
        return False


def span(name: str, item: Optional[int] = None):
    """A span of the period, or ``NOOP`` while the flag is off (see the
    module docstring)."""
    if not _state.live:
        return NOOP
    traced = torch.autograd._profiler_enabled()
    if traced:
        _state.seen_ns = time.perf_counter_ns()
    elif threading.get_ident() == _state.dispatcher:
        return NOOP    # the profiler stopped: the period has ended
    return _Span(name, getattr(_local, "item", None) if item is None
                 else item, traced)


def count(name: str, n: int = 1) -> None:
    if _state.live:
        with _state.lock:
            _state.counters[name] = _state.counters.get(name, 0) + n


class Marks:
    """The phase marks of one captured graph: their names and the events
    captured as its event-record nodes.  Once bound to the graph's
    executable (``bind``), each replay while the flag is on records them
    into a set of events of its own, taken in turn from ``RING`` sets."""

    def __init__(self):
        self.names: List[str] = []
        self.events: List["torch.cuda.Event"] = []
        self.exec: Optional[int] = None    # CUgraphExec
        self.nodes: List[int] = []         # CUgraphNode, in mark order
        self.ring: List[List["torch.cuda.Event"]] = []
        self.replays = 0


@contextlib.contextmanager
def capture():
    """Collects the marks of the graph captured inside: yields its
    ``Marks``."""
    marks = Marks()
    _state.capturing = marks
    try:
        yield marks
    finally:
        _state.capturing = None


def mark(name: str) -> None:
    """Marks the end of phase ``name`` in a graph being captured inside
    ``capture()``; nothing elsewhere."""
    marks = _state.capturing
    if marks is None or not torch.cuda.is_available() or \
            not torch.cuda.is_current_stream_capturing():
        return
    event = torch.cuda.Event(enable_timing=True, external=True)
    event.record()
    marks.names.append(name)
    marks.events.append(event)


def _driver():
    """The CUDA driver's graph calls that ``bind`` and ``replay`` use."""
    global _DRIVER
    if _DRIVER is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.c_void_p
        for fn, args in (
                ("cuGraphGetNodes", (p, ctypes.POINTER(p),
                                     ctypes.POINTER(ctypes.c_size_t))),
                ("cuGraphNodeGetType", (p, ctypes.POINTER(ctypes.c_int))),
                ("cuGraphEventRecordNodeGetEvent", (p, ctypes.POINTER(p))),
                ("cuGraphExecEventRecordNodeSetEvent", (p, p, p))):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _DRIVER = lib
    return _DRIVER


def _check(result: int, call: str) -> None:
    if result != 0:
        raise RuntimeError(f"{call} failed: CUresult {result}")


def bind(marks: Marks, graph: "torch.cuda.CUDAGraph") -> None:
    """Binds ``marks`` to ``graph``, captured with ``keep_graph=True`` and
    instantiated: finds the event-record node of each mark.  Where the
    driver refuses, the marks stay unbound and are never read."""
    if not marks.events:
        return
    try:
        lib = _driver()
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        _check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)),
               "cuGraphGetNodes")
        by_event = {}
        kind, event = ctypes.c_int(), ctypes.c_void_p()
        for node in nodes:
            _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
                   "cuGraphNodeGetType")
            if kind.value == EVENT_RECORD_NODE:
                _check(lib.cuGraphEventRecordNodeGetEvent(
                    node, ctypes.byref(event)),
                       "cuGraphEventRecordNodeGetEvent")
                by_event[event.value] = node
        marks.nodes = [by_event[e.cuda_event] for e in marks.events]
        marks.exec = graph.raw_cuda_graph_exec()
    except (OSError, AttributeError, KeyError, RuntimeError) as e:
        warnings.warn(f"phase marks left unread: {e!r}")


def _ring_slot(marks: Marks, i: int) -> List["torch.cuda.Event"]:
    while len(marks.ring) <= i:
        events = [torch.cuda.Event(enable_timing=True) for _ in marks.events]
        for e in events:
            e.record()   # creates it, and elapsed_time asks for a record
        marks.ring.append(events)
    return marks.ring[i]


def replay(marks: Marks, apply: bool) -> None:
    """Called just before a graph with ``marks`` is replayed.  While the
    flag is on: points the graph's mark nodes at the next set of the ring,
    first reading the replay that recorded into that set ``RING`` replays
    ago (done, unless the host ran that far ahead), and leaves this
    replay's set pending.  It never waits for the replay it launches."""
    if not _state.live or marks.exec is None:
        return
    i = marks.replays % RING
    marks.replays += 1
    key = (id(marks), i)
    prev = _state.pending.pop(key, None)
    if prev is not None:
        _read(*prev)
    events = _ring_slot(marks, i)
    lib, graph_exec = _driver(), ctypes.c_void_p(marks.exec)
    for node, event in zip(marks.nodes, events):
        _check(lib.cuGraphExecEventRecordNodeSetEvent(
            graph_exec, ctypes.c_void_p(node), event._as_parameter_),
               "cuGraphExecEventRecordNodeSetEvent")
    _state.pending[key] = (marks.names, events, apply)


def _read(names: List[str], events: List["torch.cuda.Event"],
          apply: bool) -> None:
    """Adds one finished replay's phases: waits for its last mark."""
    events[-1].synchronize()
    at = [events[0].elapsed_time(e) for e in events[1:]]
    got: Dict[str, float] = {}
    last = 0.0
    for name, t in zip(names[1:], at):
        phase = PHASES.get(name) or (("update" if apply else "tail")
                                     if name == "end" else name)
        got[phase] = got.get(phase, 0.0) + t - last
        last = t
    got["replay"] = at[-1]
    for phase, ms in got.items():
        total = _state.phases.setdefault(phase, [0.0, 0])
        total[0] += ms
        total[1] += 1


def _drain() -> None:
    pending, _state.pending = _state.pending, {}
    for names, events, apply in pending.values():
        _read(names, events, apply)


def snapshot() -> dict:
    """The period's record as plain data (JSON-ready):

    - ``spans``: dicts of ``id``, ``name``, ``thread``, ``start_ns``,
      ``end_ns``, ``parent``, ``item``, by start;
    - ``phases``: per phase, ``ms`` (device milliseconds, summed) and
      ``replays`` (the replays that timed it);
    - ``counters``; ``period_ns``: its start and end; ``dropped``: spans
      past ``MAX_SPANS``.

    Reads every pending mark first (the device has been synchronized);
    closes the period where the profiler has stopped."""
    if _state.live and torch.autograd._profiler_enabled():
        _state.seen_ns = time.perf_counter_ns()
        _drain()
    elif _state.live:
        _close()
    s = _state
    lo, hi = s.start_ns, s.seen_ns
    keys = ("id", "name", "thread", "start_ns", "end_ns", "parent", "item")
    spans = sorted((r for r in list(s.spans) if lo <= r[3] <= hi),
                   key=lambda r: r[3])
    with s.lock:
        counters = dict(s.counters)
    return {"period_ns": [lo, hi],
            "spans": [dict(zip(keys, r)) for r in spans],
            "phases": {p: {"ms": ms, "replays": n}
                       for p, (ms, n) in s.phases.items()},
            "counters": counters, "dropped": s.dropped}
