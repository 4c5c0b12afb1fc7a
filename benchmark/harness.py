"""One run of one cell, its parts found by name.

Everything a cell is made of is a file that ``BENCHMARK.json`` names, or
that a file it names names in turn:

- the configuration file (``configs/<config>.json``: the CLI's argv, the
  overrides, the sizes the reference is built from, and the ``entry``);
- the traffic file (``traffic/<mix>.json``), data only: its parameters,
  and by name the ``runner`` that runs the cell, the ``format`` whose
  generator makes the inputs (``generators/<format>.py``, a
  ``make_pool(traffic, dims, seed)``, see ``traffic.py``);
- the runner (``runners/<runner>.py``): a ``run(cell, seed, seconds,
  traced, t_start, device, fault)`` that does set-up, the measured window
  and the comparison with the plain reference, and returns the result's
  line as a dict and the lines for standard error (``runners/train.py``
  says what a training run does); its ``NUMBERS``, the numbers it
  compares, and ``ENTRY``, what it needs of an entry;
- the entry that drives the program (``entries/<entry>.py``);
- the limits of the comparison (``limits/<cell>.json``);
- each per-layer metric's reader (``metrics/<metric>.py``, a
  ``read(ctx)`` of a ``TraceContext`` that returns a number or None).

So a cell, a configuration, a mix, a runner, a generator or a metric is
added by adding files, and nothing here names one of them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
JAX_NAMES = ("jax", "jaxlib", "flax", "medvill_tpu")
GIB = 2.0 ** 30


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    dims: dict          # the configuration file
    traffic: dict
    limits: dict
    metrics: Dict[str, dict]   # per-layer metrics that this cell reports
    end_to_end: Dict[str, dict]
    bench_dir: Path = BENCH_DIR


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module of the file ``path``, loaded once as ``name``."""
    known = sys.modules.get(name)
    if known is not None and getattr(known, "__file__", None) == str(path):
        return known
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def plugin(cell: Cell, folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the cell's benchmark."""
    return load_module(cell.bench_dir / folder / f"{name}.py",
                       f"bench_{folder}_" + name.replace(".", "_")
                       .replace("-", "_"))


def load_entry(cell: Cell):
    return plugin(cell, "entries", cell.dims["entry"])


def load_runner(cell: Cell):
    return plugin(cell, "runners", cell.traffic["runner"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json's contents), its
    files found under ``root``'s ``benchmark/``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    c = cells[name]
    config = {x["name"]: x for x in bench["configs"]}[c["config"]]
    here = Path(root) / "benchmark"
    return Cell(
        name=name, chips=c["chips"], dims=load_json(Path(root) /
                                                    config["file"]),
        traffic=load_json(here / "traffic" / f"{c['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        metrics={m["name"]: m for m in bench["per_layer"]
                 if _applies(m, name)},
        end_to_end={m["name"]: m for m in bench["end_to_end"]
                    if _applies(m, name)}, bench_dir=here)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    words = np.random.SeedSequence([seed % 2 ** 64,
                                    *tag.encode()]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _set(obj, path: str, value):
    """A copy of the dataclass ``obj`` with the dotted ``path`` set."""
    head, _, rest = path.partition(".")
    if rest:
        value = _set(getattr(obj, head), rest, value)
    return dataclasses.replace(obj, **{head: value})


def program_config(entry, dims: dict):
    """The program's configuration as its CLI builds it from the file's
    argv, with the file's overrides; raises where it disagrees with the
    file's numbers."""
    cfg = entry.program_config(dims["argv"])
    for path, value in dims.get("overrides", {}).items():
        cfg = _set(cfg, path, value)
    wrong = []
    for key, path in dims["program"].items():
        got = cfg
        for part in path.split("."):
            got = getattr(got, part)
        if got != dims[key]:
            wrong.append(f"{key}: program {got!r}, file {dims[key]!r}")
    if entry.mask_name(cfg) != dims["mask"]:
        wrong.append(f"mask: program {entry.mask_name(cfg)}, file "
                     f"{dims['mask']}")
    if wrong:
        raise ValueError("the program's configuration is not the file's: "
                         + "; ".join(wrong))
    return cfg


def span(traced: bool, name: str):
    """A benchmark host span: a ``record_function`` range while the
    profiler runs, nothing otherwise."""
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function("bench." + name)


class TraceContext:
    """What a per-layer metric's reader reads (``metrics/<name>.py``): the
    reduced trace, and what the cell's runner adds as attributes (the
    training runner: ``micro_steps``, ``updates``, ``bounds``, ``flops``,
    ``peak_flops``)."""

    def __init__(self, trace, **values):
        self.trace = trace
        self.kinds = trace.kind_seconds()
        self.window_s, self.busy_s = trace.window_s, trace.busy_s
        self.__dict__.update(values)

    def span_seconds(self, name: str) -> List[float]:
        return self.trace.span_seconds(name)

    def op_seconds(self, *kinds: str) -> float:
        return sum(self.kinds.get(k, 0.0) for k in kinds)

    def runtime_seconds(self, name: str) -> List[Dict[str, float]]:
        """Per instance of span ``name``: seconds by CUDA runtime call."""
        return self.trace.runtime_seconds(name)


def read_metrics(cell: Cell, ctx: TraceContext) -> Dict[str, dict]:
    """The cell's per-layer metrics that their readers find in ``ctx``."""
    out = {}
    for name, m in cell.metrics.items():
        value = plugin(cell, "metrics", name).read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def jax_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_NAMES)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", fault=None):
    """Returns (the result's line as a dict, the lines for standard
    error), from the cell's runner.  ``fault``, for the tests only, is
    handed to the runner, which lets it break the timed path."""
    return load_runner(cell).run(cell, seed, seconds, traced, t_start,
                                 device=device, fault=fault)
