"""BENCHMARK.json against the benchmark's contract, every cell against its
files, and cells, runners and generators added by files alone.  Nothing
here names a cell, a configuration or a metric: each check is a property
of whatever BENCHMARK.json lists."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness, traffic
from benchmark.reference import models
from benchmark.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
# a key that names a width, which a configuration may never cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"_size|_dim$|_rank$|expansion|experts_per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check of 24 cells fits in 12 hours
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    configs = BENCH["configs"]
    assert 1 <= len(configs) <= 24
    assert len({c["name"] for c in configs}) == len(configs)
    assert len({c["file"] for c in configs}) == len(configs)
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert all(NAME.match(k) for k in c["reduced"])
        dims = harness.load_json(harness.ROOT / c["file"])
        assert dims["source"] == c["source"]
        assert dims["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len(set(CELLS)) == len(CELLS)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    # at most a quarter of the cells on four chips, or one
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_metrics():
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    bounds = {m["name"]: m["bound"] for m in e2e}
    assert bounds["setup_s"] <= 0.25
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in bounds
        # every cell that reads it reports the metric it moves
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(m.get("workloads", CELLS)) <= set(
            moved.get("workloads", CELLS))
    assert len({m["name"] for m in e2e + per}) == len(e2e) + len(per)


@pytest.mark.parametrize("name", CELLS)
def test_every_workload_resolves(name):
    """Each cell reports set-up, another end-to-end metric and a per-layer
    one, and finds its runner, generator, entry, reference model, limits
    and readers."""
    cell = harness.load_cell(BENCH, name)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.metrics
    runner = harness.load_runner(cell)
    assert callable(runner.run)
    entry = harness.load_entry(cell)
    for attr in runner.ENTRY:
        assert hasattr(entry, attr), attr
    ref = models.load(entry.MODEL)
    for attr in ("TRUNK", "param_spec", "trainable", "pixels", "loss"):
        assert hasattr(ref, attr), attr
    assert set(cell.limits) == set(runner.NUMBERS)
    gen = harness.plugin(cell, "generators", cell.traffic["format"])
    assert callable(gen.make_pool)
    for metric in cell.metrics:
        assert callable(harness.plugin(cell, "metrics", metric).read)
    # the program's configuration, as its CLI builds it, is the file's
    harness.program_config(entry, cell.dims)


def _copy(tmp_path):
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "benchmark"


def test_a_cell_added_by_files_alone(tmp_path):
    """A new traffic mix, cell, limits and per-layer metric, as files
    beside a copy of the benchmark, run with no edit to its code."""
    here = _copy(tmp_path)
    cell0 = harness.load_cell(BENCH, CELLS[0])
    mix = dict(cell0.traffic)
    mix["report_wordpieces"] = dict(mix["report_wordpieces"], median=40)
    (here / "traffic" / "short-mix.json").write_text(json.dumps(mix))
    (here / "limits" / "added-short.json").write_text(
        json.dumps(cell0.limits))
    (here / "metrics" / "micro_steps.added.py").write_text(
        "def read(ctx):\n    return float(ctx.micro_steps)\n")
    bench = json.loads(json.dumps(BENCH))
    config = next(w["config"] for w in BENCH["workloads"]
                  if w["name"] == CELLS[0])
    bench["workloads"].append({
        "name": "added-short", "config": config, "traffic": "short-mix",
        "chips": 1, "why": "shorter reports"})
    moves = next(m["name"] for m in BENCH["end_to_end"]
                 if m["name"] != "setup_s")
    bench["per_layer"].append({
        "name": "micro_steps.added", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "dispatch", "moves": moves,
        "workloads": ["added-short"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("added-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(bench, "added-short", tmp_path)
    assert cell.traffic["report_wordpieces"]["median"] == 40
    assert cell.bench_dir == here
    result, _ = tiny.run(tiny.shrink(cell), traced=True)
    assert result["correct"]
    assert result["metrics"]["micro_steps.added"]["value"] >= 1


RUNNER = '''
def run(cell, seed, seconds, traced, t_start, device="cuda", fault=None):
    from benchmark import traffic
    pool = traffic.make_pool(cell, seed)
    n = sum(len(b["ids"]) for b in pool)
    return ({"correct": True, "attempted": n, "failed": 0,
             "metrics": {"requests_per_s": {"value": n / seconds,
                                            "unit": "1/s"}}}, ["echo"])
'''
GENERATOR = '''
import numpy as np
def make_pool(traffic, dims, seed):
    rng = np.random.default_rng(seed)
    return [{"ids": rng.integers(0, dims["vocab_size"],
                                 traffic["requests"])}
            for _ in range(traffic["batches"])]
'''


def test_a_runner_and_a_generator_added_by_files_alone(tmp_path):
    """A kind of cell that no runner here runs (a serving loop, a loader
    cell, a save and resume) comes as a runner, a generator and a mix:
    files alone, which the harness finds by the names in the mix."""
    here = _copy(tmp_path)
    (here / "runners" / "echo.py").write_text(RUNNER)
    (here / "generators" / "requests.py").write_text(GENERATOR)
    (here / "traffic" / "echo-mix.json").write_text(json.dumps(
        {"runner": "echo", "format": "requests", "requests": 3,
         "batches": 5}))
    (here / "limits" / "echo-cell.json").write_text("{}")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "echo-cell", "config": BENCH["configs"][0]["name"],
        "traffic": "echo-mix", "chips": 4, "why": "a cell of its own kind"})
    cell = harness.load_cell(bench, "echo-cell", tmp_path)
    assert cell.chips == 4
    assert len(traffic.make_pool(cell, 7)) == 5
    result, lines = harness.run_cell(cell, 7, 2.0, False, 0.0, "cpu")
    assert result["attempted"] == 15 and lines == ["echo"]
