"""What the benchmark imports, by top-level module names compared whole,
and a run without the program."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

from benchmark import harness

JAX = {"jax", "jaxlib", "flax", "medvill_tpu"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere_and_no_program_in_the_reference():
    files = sorted((harness.ROOT / "benchmark").rglob("*.py"))
    assert files
    for path in files:
        names = _imports(path)
        assert not names & JAX, (path, names & JAX)
        if "reference" in path.relative_to(harness.ROOT).parts:
            assert "medvill_torch" not in names, path
    # whole names: the port's name begins with the JAX package's
    assert "medvill_torch".split(".")[0] not in JAX


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and benchmark/: the program is missing, so the
    run exits with an error and prints no result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark.tests import tiny;"
            "tiny.run(tiny.cell('pretrain-r50-bar', tiny.harness.ROOT))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "medvill_torch" in proc.stderr
    for line in proc.stdout.splitlines():
        try:
            assert "correct" not in json.loads(line)
        except json.JSONDecodeError:
            pass
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pretrain-r50-bar", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "correct" not in proc.stdout
