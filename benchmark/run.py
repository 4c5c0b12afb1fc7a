"""The benchmark of the PyTorch and CUDA port (``medvill_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once in this process (see
``harness.py``) on the chips of the machine it is started on, and prints
the result as the last line of standard output: ``correct``,
``attempted`` and ``failed`` micro-steps, the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics and a ``breakdown`` (``--trace
1``), the device, the set-up's pieces, and last the numbers compared with
the reference beside their limits, which also end standard error.  It
exits 1, printing no result, without enough CUDA devices, or where a JAX
module is loaded.  Build and kernel caches stay in this checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.load_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
        args.workload)
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    found = harness.jax_modules()
    if found:
        print(f"JAX modules loaded: {found}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
