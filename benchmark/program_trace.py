"""What the port's own tracing (``medvill_torch.utils.tracing``) recorded
over the traced window, for the per-layer readers in ``metrics/``.  A
program without that module gives None, and so does every reader of it.

The window's profiler runs on the thread that dispatches, so the port's
record covers the window's dispatches: the host spans, the counters, and
the device milliseconds of each phase of the graphed micro-step, timed by
events captured in its CUDA graph."""
from __future__ import annotations

from typing import Optional

LOADER = ("loader.fetch", "loader.pin", "loader.h2d")


def snapshot() -> Optional[dict]:
    try:
        from medvill_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def phase(name: str) -> Optional[dict]:
    """``{"ms", "replays"}`` of phase ``name``, or None where no replay
    timed it."""
    snap = snapshot()
    got = snap["phases"].get(name) if snap else None
    return got if got and got["replays"] else None


def phase_ms(name: str) -> Optional[float]:
    """Device milliseconds of phase ``name`` per replay that timed it."""
    got = phase(name)
    return got["ms"] / got["replays"] if got else None


def loader_ms_per_group() -> Optional[float]:
    """The loader thread's milliseconds (its fetch, pin and copy spans)
    per group it placed on the device (a ``loader.h2d`` span)."""
    snap = snapshot()
    if not snap:
        return None
    spans = [s for s in snap["spans"] if s["name"] in LOADER]
    placed = {s["item"] for s in spans if s["name"] == "loader.h2d"}
    if not placed:
        return None
    busy = sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["item"] in placed)
    return busy / len(placed) / 1e6


def counter(name: str) -> int:
    snap = snapshot()
    return snap["counters"].get(name, 0) if snap else 0
