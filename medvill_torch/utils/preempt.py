"""Preemption-tolerant training: a SIGTERM guard for the trainer loops (a
copy of medvill_tpu/utils/preempt.py, which imports no JAX).

Spot and maintenance events surface as SIGTERM with a short grace window.
The reference has no equivalent: a preempted run loses everything since its
last epoch checkpoint.  A trainer polls a :class:`PreemptionGuard` between
micro-steps and, when a signal has arrived, saves a checkpoint and exits 0.
The marker helpers record an interrupted position (``preempt.json``) for a
trainer that resumes mid-epoch; the port's retrieval CLI uses the guard
save-only, as the JAX one does (its pairs are resampled every epoch, so
there is no position to replay).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Iterable, Optional

from medvill_torch import parallel

PREEMPT_FILE = "preempt.json"
# the multi-process collective-poll cadence of the classification and
# retrieval CLIs (every POLL_EVERY batches, as the JAX package's); one
# process reads its flag every batch, and the pretrain and finetune CLIs
# poll at every dispatch
POLL_EVERY = 8


class PreemptionGuard:
    """Context manager installing signal handlers that only set a flag.

    The handler does no I/O (async-signal-safe); trainer loops poll
    :attr:`triggered` between dispatches and run the save themselves.
    SIGINT is deliberately not claimed — Ctrl-C keeps its normal
    KeyboardInterrupt semantics for interactive runs.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 logger: Optional[logging.Logger] = None):
        self._signals = tuple(signals)
        self._logger = logger
        self._prev: dict = {}
        self._event = threading.Event()
        self.signum: Optional[int] = None

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def _handler(self, signum, frame):
        self.signum = signum
        self._event.set()
        if self._logger is not None:
            # logging from a signal handler is not strictly re-entrant but
            # this fires once at shutdown; keep it best-effort
            try:
                self._logger.warning(
                    "received signal %d: finishing current dispatch, then "
                    "checkpoint + clean exit", signum)
            except Exception:
                pass

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("PreemptionGuard must be entered from the "
                               "main thread (signal.signal requirement)")
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False


def agreed(guard: PreemptionGuard, batch_idx: Optional[int] = None) -> bool:
    """Whether to stop here: the guard's flag, OR-ed over every rank under
    ``torch.distributed`` (``parallel.global_any``, medvill_tpu/core/
    mesh.py:228), so a SIGTERM on one rank stops every rank at the same
    boundary.  With ``batch_idx`` (the classification and retrieval CLIs)
    a multi-rank run polls only every ``POLL_EVERY`` batches, gated on
    that shared counter; one process reads its flag every time."""
    if not parallel.multi_process():
        return guard.triggered
    if batch_idx is not None and (batch_idx + 1) % POLL_EVERY:
        return False
    return parallel.global_any(guard.triggered)


def write_marker(output_path: str, epoch: int, batches_done: int) -> str:
    """Record the interrupted position next to the checkpoint.  A resume
    run consumes (and deletes) this to skip ``batches_done`` host batches
    of ``epoch``.

    Multi-host safe: every process writes the same agreed position (the
    trainers only save after a ``global_any`` agreement), so concurrent
    writers are benign as long as each write is atomic — write to a
    per-process temp file and ``os.replace`` it in, so no reader ever
    sees a torn/partial JSON.  Under ``torch.distributed`` rank 0 alone
    writes it."""
    path = os.path.join(os.path.abspath(output_path), PREEMPT_FILE)
    if not parallel.is_main():
        return path
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch), "batches_done": int(batches_done)},
                  f)
    os.replace(tmp, path)
    return path


def read_marker(output_path: str) -> Optional[dict]:
    path = os.path.join(os.path.abspath(output_path), PREEMPT_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def clear_marker(output_path: str) -> None:
    """Consume the marker.  In multi-host runs EVERY process calls this on
    the shared filesystem at resume startup; a bare exists()-then-remove()
    is a TOCTOU race where the loser dies with FileNotFoundError while the
    winner hangs in its first collective — the remove must tolerate an
    already-removed marker."""
    path = os.path.join(os.path.abspath(output_path), PREEMPT_FILE)
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
