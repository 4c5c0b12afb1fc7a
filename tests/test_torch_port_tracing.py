"""The port's tracing (medvill_torch/utils/tracing.py) and the benchmark's
per-layer readers of it (benchmark/metrics/, benchmark/program_trace.py):

- with no profiler running, spans are the shared no-op and record nothing;
- under ``torch.profiler`` the dispatching thread's spans are both
  ``medvill.*`` ranges of the profile and records of ``snapshot()``, with
  their parents; the loader thread's spans follow the flag, and what it
  records after the profiler stopped is left out;
- loader-group ids join a placed group to the dispatch that takes it;
- ``mark()`` does nothing on the CPU or outside a capture;
- a CPU ``MultiStep`` under the profiler counts its eager micro-steps;
- each reader on a hand-built snapshot and trace, and None on an empty
  one or without the tracing module.

The phase marks of a captured micro-step are held on the card in
tests/test_torch_port_cuda.py.

The file imports neither jax nor medvill_tpu."""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark import trace as trace_lib
from medvill_torch.data import pretrain as tdata
from medvill_torch.train import dispatch
from medvill_torch.train import pretrain as tpre
from medvill_torch.utils import tracing
from tests.test_torch_port_cuda import _pretrain_batch, _tiny_pretrain

READERS = ("image_ms.train", "fwd_ms.train", "bwd_ms.train",
           "update_ms.train", "replay_gap_ms.train", "loader_busy_ms.train",
           "replay_share.train")


@pytest.fixture(autouse=True)
def fresh():
    """One torch thread, and no period or loader group left over from
    another test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.refresh()   # closes a period whose profiler has stopped
    tracing.set_item(None)
    yield
    tracing.refresh()
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _range_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(tracing.PREFIX)]


def test_spans_without_a_profiler_are_the_shared_no_op():
    tracing.refresh()
    spans, counters = list(tracing._state.spans), dict(
        tracing._state.counters)
    for name in ("dispatch", "loader.fetch"):
        assert tracing.span(name) is tracing.NOOP
        assert tracing.span(name, item=3) is tracing.NOOP
        with tracing.span(name):
            pass
    tracing.count("dispatch.replays")
    assert tracing._state.spans == spans
    assert tracing._state.counters == counters


def test_dispatching_thread_spans_are_profiler_ranges_and_records():
    with _cpu_profile() as prof:
        tracing.refresh()
        with tracing.span("outer", item=7):
            with tracing.span("inner"):
                torch.ones(3).sum()
            with tracing.span("inner2", item=8):
                pass
        tracing.count("hits", 2)
        tracing.count("hits")
        snap = tracing.snapshot()
    assert sorted(_range_names(prof)) == ["medvill.inner", "medvill.inner2",
                                          "medvill.outer"]
    spans = {s["name"]: s for s in snap["spans"]}
    assert set(spans) == {"outer", "inner", "inner2"}
    outer = spans["outer"]
    assert outer["parent"] is None and outer["item"] == 7
    assert spans["inner"]["parent"] == outer["id"]
    assert spans["inner2"]["parent"] == outer["id"]
    assert spans["inner2"]["item"] == 8 and spans["inner"]["item"] is None
    for s in spans.values():
        assert s["thread"] == threading.current_thread().name
        assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= outer["end_ns"]
    assert snap["counters"] == {"hits": 3}
    # after the profiler: nothing more, and the same record
    with tracing.span("later"):
        pass
    assert tracing.snapshot() == snap


def _slow_batches(n, delay=0.005):
    for i in range(n):
        time.sleep(delay)
        yield {"a": np.full((2, 3), i, np.int32)}


def test_loader_thread_spans_follow_the_flag_and_stop_with_the_profiler():
    """The loader's spans are recorded while the flag is on, carry their
    group's id, never become profiler ranges, and those it starts after
    the dispatching thread last saw the profiler running are left out; once
    the period is closed the loader records nothing."""
    it = iter(tdata.dispatch_loader(_slow_batches(40), "cpu"))
    next(it)   # the thread runs before the profiler starts
    with _cpu_profile() as prof:
        tracing.refresh()
        got = []
        for _ in range(4):
            batch, _ = next(it)
            with tracing.span("dispatch"):
                got.append(int(batch["a"][0, 0]))
    stopped = time.perf_counter_ns()
    for _ in range(4):   # the loader goes on while the flag is still on
        next(it)
    recorded = len(tracing._state.spans)
    snap = tracing.snapshot()   # closes the period
    assert recorded > len(snap["spans"])
    assert not [n for n in _range_names(prof) if "loader" in n]
    loader = [s for s in snap["spans"] if s["name"].startswith("loader.")]
    assert {s["name"] for s in loader} == {"loader.fetch", "loader.h2d"}
    assert all(s["thread"] != threading.current_thread().name
               and s["item"] is not None and s["start_ns"] <= stopped
               for s in loader)
    assert got == [1, 2, 3, 4]
    time.sleep(0.05)   # a span open at the close lands as it ends
    settled = len(tracing._state.spans)
    for _ in range(4):
        next(it)
    assert len(tracing._state.spans) == settled
    assert tracing.snapshot() == snap
    it.close()


def test_spans_counters_and_items_from_many_threads_lose_nothing():
    """Twelve threads (more than this host's cores) at a short switch
    interval record spans, counters and loader-group ids while the flag is
    on: every span is kept once with its own parent, the counter sums every
    add, and no two groups share an id."""
    threads, per = 12, 200
    interval = sys.getswitchinterval()
    items = []
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            tracing.refresh()

            def work():
                got = [tracing.new_item() for _ in range(per)]
                for i in got:
                    with tracing.span("outer", item=i):
                        with tracing.span("inner"):
                            tracing.count("n")
                items.extend(got)

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
            snap = tracing.snapshot()
    finally:
        sys.setswitchinterval(interval)
    spans = snap["spans"]
    assert snap["counters"] == {"n": threads * per}
    assert len(items) == len(set(items)) == threads * per
    outer = {s["id"]: s for s in spans if s["name"] == "outer"}
    inner = [s for s in spans if s["name"] == "inner"]
    assert len(outer) == len(inner) == threads * per
    assert sorted(s["item"] for s in outer.values()) == sorted(items)
    assert sorted(s["parent"] for s in inner) == sorted(outer)
    for s in inner:
        assert outer[s["parent"]]["thread"] == s["thread"]


def test_items_join_each_placed_group_to_its_dispatch():
    """In order of consumption, each dispatch's item is the id of the group
    the loader thread fetched and placed for it, and the placement ended
    before the dispatch began."""
    batches = ({"a": np.full((2, 3), i, np.int32)} for i in range(12))
    with _cpu_profile():
        tracing.refresh()
        seen = []
        for batch, is_group in tdata.dispatch_loader(batches, "cpu", k=2):
            assert is_group
            with tracing.span("dispatch"):
                seen.append(int(batch["a"][0, 0, 0]))
        snap = tracing.snapshot()
    assert seen == [0, 2, 4, 6, 8, 10]
    dispatches = [s for s in snap["spans"] if s["name"] == "dispatch"]
    placed = {s["item"]: s for s in snap["spans"]
              if s["name"] == "loader.h2d"}
    fetched = {s["item"] for s in snap["spans"]
               if s["name"] == "loader.fetch"}
    assert len(dispatches) == 6
    items = [s["item"] for s in dispatches]
    assert len(set(items)) == 6 and set(items) <= set(placed) <= fetched
    assert items == sorted(items)
    for d in dispatches:
        assert placed[d["item"]]["end_ns"] <= d["start_ns"]


def test_marks_do_nothing_on_the_cpu_or_outside_a_capture():
    tracing.mark("start")
    with tracing.capture() as marks:
        tracing.mark("start")
        tracing.mark("end")
    assert marks.names == [] and tracing._state.capturing is None
    assert marks.exec is None
    tracing.replay(marks, True)
    assert tracing._state.pending == {}


def _tiny_multi(n):
    """A 2-layer pretrain model's state (accumulation 2), its k = 2
    ``MultiStep`` and ``n`` groups, on the CPU."""
    cfg, cpu = _tiny_pretrain(), torch.device("cpu")
    state = tpre.init_state(cfg, seed=0, device=cpu)
    batches = [_pretrain_batch(cpu, cfg, i) for i in range(2 * n)]
    groups = [{k: torch.stack([b[k] for b in batches[i:i + 2]])
               for k in batches[0]} for i in range(0, 2 * n, 2)]
    return state, dispatch.MultiStep(tpre.make_train_step(cfg), 2), groups


def test_cpu_multi_step_under_the_profiler_counts_its_eager_steps():
    """A CPU ``MultiStep`` (k = 2) traced for its last two dispatches:
    four eager micro-steps, no replay, each dispatch with its draw and two
    eager spans inside; its losses equal an untraced twin's."""
    losses = {}
    for traced in (False, True):
        state, multi, groups = _tiny_multi(3)
        gen = torch.Generator().manual_seed(1)
        out = [multi(state, groups[0], gen)["loss"]]
        with _cpu_profile() if traced else contextlib.nullcontext():
            out += [multi(state, g, gen)["loss"] for g in groups[1:]]
            snap = tracing.snapshot()
        losses[traced] = torch.cat(out)
    assert torch.equal(losses[True], losses[False])
    assert snap["counters"] == {"dispatch.eager_steps": 4}
    assert snap["phases"] == {}
    spans = snap["spans"]
    tops = [s for s in spans if s["name"] == "dispatch"]
    assert len(tops) == 2 and all(s["parent"] is None for s in tops)
    for top in tops:
        kids = [s["name"] for s in spans if s["parent"] == top["id"]]
        assert kids == ["dispatch.draw", "dispatch.eager", "dispatch.eager"]


# --- the benchmark's readers -------------------------------------------------

def _reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "bench_metrics_" + name.replace(".", "_"))


def _ctx(micro_steps=8, updates=2, window_s=0.2, ops=None):
    ops = ops or {"cudnn_conv_kernel": (16, 0.024),
                  "batch_norm_collect_statistics": (16, 0.008),
                  "multi_tensor_apply_kernel_adam": (2, 0.006)}
    tr = trace_lib.Trace(spans={}, ops=ops, window_s=window_s,
                         busy_s=0.19, gaps=[], runtime=[])
    return harness.TraceContext(tr, micro_steps=micro_steps,
                                updates=updates)


def _span(i, name, start_ms, end_ms, item):
    return {"id": i, "name": name, "thread": "loader", "parent": None,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6),
            "item": item}


SNAPSHOT = {
    "period_ns": [0, 10 ** 9], "dropped": 0,
    # 8 replays: 6 accumulate, 2 apply
    "phases": {"image": {"ms": 40.0, "replays": 8},
               "forward": {"ms": 48.0, "replays": 8},
               "backward": {"ms": 88.0, "replays": 8},
               "update": {"ms": 7.0, "replays": 2},
               "tail": {"ms": 0.6, "replays": 6},
               "replay": {"ms": 183.6, "replays": 8}},
    "counters": {"dispatch.replays": 8},
    "spans": [_span(1, "loader.fetch", 0, 3, 11),
              _span(2, "loader.pin", 3, 5, 11),
              _span(3, "loader.h2d", 5, 6, 11),
              _span(4, "loader.fetch", 6, 10, 12),
              _span(5, "loader.pin", 10, 11, 12),
              _span(6, "loader.h2d", 11, 13, 12),
              # fetched, not placed inside the period: left out
              _span(7, "loader.fetch", 13, 20, 13),
              _span(8, "dispatch", 6, 30, 11)]}
EMPTY = {"period_ns": [0, 0], "dropped": 0, "phases": {}, "counters": {},
         "spans": []}


def test_readers_on_a_hand_built_snapshot(monkeypatch):
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    ctx = _ctx()
    got = {name: _reader(name).read(ctx) for name in READERS}
    want = {"image_ms.train": 5.0, "fwd_ms.train": 6.0,
            "bwd_ms.train": 11.0, "update_ms.train": 3.5,
            "replay_gap_ms.train": (200.0 - 183.6) / 8,
            "loader_busy_ms.train": (6.0 + 7.0) / 2,
            "replay_share.train": 100.0}
    assert got == pytest.approx(want)
    # the phases contain the kernels the name-based readers sum
    assert got["image_ms.train"] >= _reader("trunk_ms.train").read(ctx)
    assert got["update_ms.train"] >= _reader("optim_ms.train").read(ctx)
    snap = dict(SNAPSHOT, counters={"dispatch.replays": 6,
                                    "dispatch.eager_steps": 2})
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert _reader("replay_share.train").read(ctx) == 75.0


def test_readers_give_none_on_an_empty_record_or_without_tracing(
        monkeypatch):
    ctx = _ctx()
    monkeypatch.setattr(tracing, "snapshot", lambda: EMPTY)
    assert {n: _reader(n).read(ctx) for n in READERS} == dict.fromkeys(
        READERS)
    # a program without the tracing module (an older commit)
    monkeypatch.setitem(sys.modules,
                        "medvill_torch.utils.tracing", None)
    assert {n: _reader(n).read(ctx) for n in READERS} == dict.fromkeys(
        READERS)
