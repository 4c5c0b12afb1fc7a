"""Learning-dynamics proof of the port: every workload, driven through the
port's CLIs on the structured synthetic corpus, reaches its overfit target
(tools/torch_overfit.py on the CPU; the JAX package's counterpart is
tests/test_overfit.py).  One command reproduces it by hand:
``python tools/torch_overfit.py --device cpu``.  The pretrain stage runs
once per session and the retrieve and finetune stages recover from it, as
the reference pipeline does."""
import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(workloads: str, root, timeout: int, pretrained: str = None):
    cmd = [sys.executable, os.path.join(REPO, "tools", "torch_overfit.py"),
           "--device", "cpu", "--workloads", workloads, "--root", str(root)]
    if pretrained:
        cmd += ["--pretrained", pretrained]
    r = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True, timeout=timeout)
    rows = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert len(rows) == len(workloads.split(","))
    for row in rows:
        assert row["ok"], row
    return rows


@pytest.fixture(scope="session")
def pretrain_run(tmp_path_factory):
    """(result rows, the pretrain output directory)."""
    root = tmp_path_factory.mktemp("torch_overfit") / "ov"
    rows = _run("pretrain", root, timeout=3600)
    return rows, str(root / "pretrain")


def test_overfit_pretrain(pretrain_run):
    rows, _ = pretrain_run
    assert rows[0]["detail"]["mlm_acc"] > 0.9, rows


def test_overfit_classify_retrieve(tmp_path, pretrain_run):
    _, run = pretrain_run
    _run("classify,retrieve", tmp_path / "ov", timeout=2400, pretrained=run)


def test_overfit_finetune_decode(tmp_path, pretrain_run):
    _, run = pretrain_run
    _run("finetune", tmp_path / "ov", timeout=2400, pretrained=run)
