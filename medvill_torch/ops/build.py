"""Build the hand-written CUDA kernels under ``ops/csrc/`` with ``nvcc`` and
load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``ops/_build/lib<name>-<hash>.so``, its ``nvcc`` log (ptxas' ``-v``
report, read by ``ptxas_report``) beside it as ``.log``; the hash covers the
source and the flags, so an edited kernel is rebuilt at its next use and an unchanged one is
reused.  ``compile_all`` starts one ``nvcc`` per source at once and waits for
all of them.  Nothing here runs at import time: the CPU tests import every
module of the package on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built on a host with the CUDA "
                           "toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def ptxas_report(log: str) -> Dict[str, dict]:
    """ptxas' ``-v`` lines per entry function: {"<kernel>[<f32|bf16>]":
    {"registers", "spill_stores", "spill_loads", "static_smem"}} (dynamic
    shared memory is the launch's and is not in the log).  A kernel with
    integer template arguments is named with them, as
    ``"fused_ln_bwd_kernel<3>[bf16]"``."""
    report: Dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = re.search(r"\d([a-z][a-z_]*_kernel)", m.group(1))
            dtype = "bf16" if "nv_bfloat16" in m.group(1) else "f32"
            ints = re.findall(r"Li(\d+)E", m.group(1))
            name = kernel.group(1) if kernel else m.group(1)
            if ints:
                name += f"<{','.join(ints)}>"
            entry = report.setdefault(f"{name}[{dtype}]", {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["static_smem"] = int(m.group(1)) if m else 0
    return report


def compile_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel (all of ``csrc/`` by default) that is not
    built yet, one ``nvcc`` process per source, all started together.
    Returns {name: {"seconds": float, "log": nvcc stderr}}; a kernel already
    built (library and log) reports 0 seconds and the log of its build.
    Raises on any failure."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = []
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            report[name] = {"seconds": 0.0, "log": log.read_text()}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n"
                            f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(stderr)
        report[name] = {"seconds": time.perf_counter() - t0, "log": stderr}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``.  Its first use builds
    every kernel of ``csrc/`` not built yet, all at once (``compile_all``),
    so a program that loads several waits for one ``nvcc`` round."""
    with _lock:
        if name not in _libs:
            compile_all()
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
