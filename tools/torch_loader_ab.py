"""The training CLIs with their prefetching input pipeline against the
serial one, in turns, on one NVIDIA GPU.

    python tools/torch_loader_ab.py [--rounds 3] \
        [--cli pretrain finetune classify] [--out DIR]

"prefetch" runs a CLI as it is: ``dispatch_loader`` builds the next
batches on a background thread and copies them to the card from pinned
memory on a side stream.  "serial" replaces the CLI's ``dispatch_loader``
by a generator that fetches each batch and copies it to the card in the
training loop (``torch.as_tensor(v).to(device, non_blocking=True)``), the
CLIs' pipeline before the prefetching loader.  Each round runs serial,
prefetch, prefetch, serial; each run trains 2 epochs from random weights
and the rate is the second epoch's, as the CLI writes it to
metrics.jsonl: pairs/s (pretrain: chip_smoke.py's 288 records repeated
SCALE times, batch 36, 4 loader threads: 64 micro-steps), reports/s
(finetune: its first 96 records repeated SCALE times, batch 4,
``{"fused_ln": true}``, 1 thread: 192 micro-steps) or examples/s
(classify: chip_smoke.py's fixture with 4 x SCALE train batches of 56, 1
thread, the valid split evaluated after each epoch but outside the
epoch's time).  An epoch takes ~16-22 s on an H100, long enough that
runs of one variant agree within a few percent.  The
records share chip_smoke.py's images, and every record is decoded and
tokenized anew.  One JSON line per run and one summary per CLI: each
variant's rates, mean and spread (largest over smallest), and prefetch
over serial in each round; the CLIs' logs go to ``--out``.  Needs a CUDA
device.  Each run writes its CLI's checkpoints (about 1 GB, deleted after
the run); where a machine caps the bytes written, run one ``--cli`` at a
time (the three CLIs at 3 rounds write ~46 GB).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from medvill_torch.cli import (classification_main,  # noqa: E402
                               finetune_main, pretrain_main)

VARIANTS = ["serial", "prefetch"]
SCALE = 8  # repeats of each CLI's records
CLIS = {"pretrain": (pretrain_main, "pairs_per_s"),
        "finetune": (finetune_main, "examples_per_s"),
        "classify": (classification_main, "examples_per_s")}


def serial_loader(loader, device, keys=None, k=1):
    """The serial pipeline: fetch, then copy from pageable memory (one
    batch per step: the CLIs run at their default --steps_per_dispatch)."""
    assert k == 1, "the serial pipeline groups no batches"
    for batch in loader:
        yield {n: torch.as_tensor(v).to(device, non_blocking=True)
               for n, v in batch.items() if keys is None or n in keys}, False


def argv_for(cli: str, d: str, vocab: str, data: dict, run: int) -> list:
    out = os.path.join(d, f"{cli}_{run}")
    common = ["--vocab_file", vocab, "--device", "cuda"]
    if cli == "pretrain":
        return common + ["--train_dataset", data["pretrain"],
                         "--output_path", out, "--epochs", "2",
                         "--log_freq", "100"]
    if cli == "finetune":
        return common + ["--src_file", data["finetune"], "--output_dir", out,
                         "--config_path", data["config"], "--max_pred",
                         "128", "--num_train_epochs", "2"]
    return common + ["--data_path", data["classify"], "--savedir", out,
                     "--max_epochs", "2"]


def rate(cli: str, result) -> float:
    rows = result if cli == "pretrain" else result["epochs"]
    return rows[1][CLIS[cli][1]]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cli", nargs="+", default=list(CLIS),
                    choices=list(CLIS))
    ap.add_argument("--out", type=str, default="chiprun_out/loader_ab")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="medvill_loader_ab_") as d:
        vocab = os.path.join(d, "vocab.txt")
        chip_smoke.write_vocab(vocab)
        pretrain = chip_smoke.write_train_data(d, vocab)
        data = {"pretrain": os.path.join(d, "pretrain.jsonl"),
                "classify": chip_smoke.write_clf_data(
                    d, vocab, train_batches=4 * SCALE),
                "config": os.path.join(d, "config.json"),
                "finetune": os.path.join(d, "finetune.jsonl")}
        with open(data["config"], "w") as f:
            json.dump({"fused_ln": True}, f)
        with open(pretrain) as f:
            lines = f.readlines()
        for name, part in (("pretrain", lines), ("finetune", lines[:96])):
            with open(data[name], "w") as f:
                f.writelines(part * SCALE)
        run = 0
        for cli in args.cli:
            module = CLIS[cli][0]
            rates = {v: [] for v in VARIANTS}
            for _ in range(args.rounds):
                for variant in VARIANTS + VARIANTS[::-1]:
                    run += 1
                    log = os.path.join(args.out, f"{cli}_{run}_{variant}.log")
                    original = module.dispatch_loader
                    if variant == "serial":
                        module.dispatch_loader = serial_loader
                    try:
                        with open(log, "w") as f, \
                                contextlib.redirect_stdout(f):
                            result = module.main(argv_for(cli, d, vocab,
                                                          data, run))
                    finally:
                        module.dispatch_loader = original
                    shutil.rmtree(os.path.join(d, f"{cli}_{run}"),
                                  ignore_errors=True)
                    r = rate(cli, result)
                    rates[variant].append(r)
                    print(json.dumps({"cli": cli, "run": run,
                                      "variant": variant, "rate": r}),
                          flush=True)
                    torch.cuda.empty_cache()
            serial, prefetch = (np.array(rates[v]) for v in VARIANTS)
            print(json.dumps({
                "cli": cli, "unit": CLIS[cli][1], **rates,
                "mean": {v: float(np.mean(r)) for v, r in rates.items()},
                "spread": {v: float(np.max(r) / np.min(r))
                           for v, r in rates.items()},
                "prefetch_over_serial": float(prefetch.mean() / serial.mean()),
                "prefetch_over_serial_by_round": [
                    float(p / s) for p, s in zip(
                        prefetch.reshape(-1, 2).mean(1),
                        serial.reshape(-1, 2).mean(1))]}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
