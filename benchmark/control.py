"""The comparison's control and its planted faults, at a training cell's own
size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--out readings.jsonl]

For each seed it makes the pool and the weights as a run of that seed
makes them and runs the float32 reference over the checked micro-steps.
Then it puts stand-ins in the program's place and reads the numbers of
the training runner's ``compare`` for each:

- ``fp8``: the reference at float8 wherever the program rounds to
  bfloat16 (e4m3 forward, e5m2 backward, ``reference/precision.py``), the
  step below the precision the configurations state: the control;
- ``half_batch``: the reference on the first half of every batch, the
  mean taken over it (a planted fault);
- ``lr_x1.3``: the reference with its learning rate 1.3 times the
  configuration's (a planted fault: a wrong schedule or scale);
- ``grad_x4/3``: the reference with every mean gradient 4/3 of what it is
  (a planted fault: the accumulated sum divided by 3 where it takes 4, a
  loss mean over 3/4 of its count);
- ``unchanged``: a step that leaves the state as it was: its losses the
  reference's, its moments and changes 0 (read without a run).

Each line names, per stand-in, whether the cell's limits pass it; every
stand-in must fail.  Beside them, the ``witness``: the reference rounded
to bfloat16 where the program rounds, which reads what the program's own
rounding costs and must pass.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stand_in_kw(cell, entry) -> dict:
    """{stand-in: what it hands the reference}; ``unchanged`` needs no
    run, and ``witness`` is the bfloat16 reference."""
    lr = entry.optimizer(cell.dims, cell.traffic)["lr"]
    return {"fp8": {"precision": "fp8"},
            "half_batch": {"rows": cell.dims["batch_size"] // 2},
            "lr_x1.3": {"optimizer": {"lr": lr * 1.3}},
            "grad_x4/3": {"grad_scale": 4.0 / 3.0},
            "witness": {"precision": "bf16"}}


def stand_ins(cell, seed: int, device) -> dict:
    """{stand-in: {number: value}} against the float32 reference, and the
    bfloat16 witness under ``"witness"``."""
    from benchmark import harness, traffic

    train = harness.load_runner(cell)
    entry = harness.load_entry(cell)
    pool = traffic.make_pool(cell, harness.sub_seed(seed, "traffic"))

    def readings(**kw):
        return train.reference(cell, entry, pool, seed, device, **kw)

    ref = readings()
    out = {}
    for name, kw in stand_in_kw(cell, entry).items():
        got = readings(**kw)
        out[name] = train.compare(train.ProgramReadings(
            got.losses, got.moment_norms, got.change_norms), ref)
    zeros = {n: 0.0 for n in ref.change_norms}
    out["unchanged"] = train.compare(train.ProgramReadings(
        ref.losses, zeros, zeros), ref)
    return out


def passes(cell, numbers: dict) -> bool:
    return all(v <= cell.limits[n]["limit"] for n, v in numbers.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    import torch

    cell = harness.load_cell(
        harness.load_json(os.path.join(ROOT, "BENCHMARK.json")),
        args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = stand_ins(cell, seed, device)
        witness = numbers.pop("witness")
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds": time.perf_counter() - t0,
                           "stand_ins": numbers, "witness": witness,
                           "passes": {n: passes(cell, v) for n, v in
                                      dict(numbers, witness=witness).items()}})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
