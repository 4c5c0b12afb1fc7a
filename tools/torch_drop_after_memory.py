"""The finetune CLI's peak memory at ``--steps_per_dispatch 4`` across
``--drop_after`` (ratio 0, then 0.2: a new pair of CUDA graphs), against
one epoch at k = 4, as the CLI ships (the first ratio's graphs are let go)
and with every ratio's ``MultiStep`` kept alive (what the CLI did before
it let them go): the yardstick of ``chip_smoke.py`` graph-steps'
``DROP_AFTER_SLACK_GIB``.  Random full-width weights, ``chip_smoke.py``'s
synthetic finetune records; needs a CUDA device:

    python tools/torch_drop_after_memory.py

Prints one JSON line per CLI run: its drop-worst ratios and its peak
allocated and reserved GiB.
"""
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from medvill_torch.cli import finetune_main  # noqa: E402

RUNS = (("one", 1), ("cross", 2), ("cross-retained", 2), ("one", 1),
        ("cross", 2))


def main() -> None:
    d = tempfile.mkdtemp(prefix="drop_after_")
    cs._write_fixture(d)
    vocab = os.path.join(d, "vocab.txt")
    argv = cs._finetune_argv(d, vocab, cs.write_train_data(d, vocab))
    i = argv.index("--model_recover_path")
    del argv[i:i + 2]  # random weights: no pretrain run needed
    real_multi, real_empty = finetune_main.MultiStep, torch.cuda.empty_cache
    kept = []

    class Kept(real_multi):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    for run, (name, epochs) in enumerate(RUNS):
        if name == "cross-retained":
            finetune_main.MultiStep = Kept
            torch.cuda.empty_cache = lambda: None
        real_empty()
        torch.cuda.reset_peak_memory_stats()
        extra = (["--drop_after", "1", "--max_drop_worst_ratio", "0.2"]
                 if epochs == 2 else [])
        rows = finetune_main.main(argv + [
            "--steps_per_dispatch", "4", "--num_train_epochs", str(epochs),
            "--output_dir", os.path.join(d, f"r{run}")] + extra)["epochs"]
        finetune_main.MultiStep, torch.cuda.empty_cache = (real_multi,
                                                           real_empty)
        kept.clear()
        print(json.dumps({
            "run": name, "ratios": [r["drop_worst_ratio"] for r in rows],
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
            "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
            flush=True)


if __name__ == "__main__":
    main()
