"""The two cells cut to a size the CPU runs in seconds, for the tests
only: a 2-layer, 32-wide BERT in float32, ResNet-50 at 64 px, 4 rows, 2
micro-steps per dispatch, a pool of 4 batches.  Never a cell."""
from __future__ import annotations

from benchmark import harness

BERT = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "compute_dtype": "float32", "img_size": 64, "batch_size": 4}
COMMON = ["--vocab_file", "unused", "--bert_model", "test-tiny",
          "--vocab_size", "64", "--img_size", "64", "--device", "cpu"]


def shrink(cell: harness.Cell) -> harness.Cell:
    d = cell.dims
    d.update(BERT)
    if d["entry"] == "pretrain":
        d.update(num_image_embeds=3, num_fibers=4, seq_len=13,
                 gradient_accumulation_steps=2)
        d["argv"] = ["--train_dataset", "unused", "--num_image_embeds", "3",
                     "--seq_len", "13", "--batch_size", "4",
                     "--gradient_accumulation_steps", "2"] + COMMON
        lengths = {"median": 6, "sigma": 0.5, "min": 2, "max": 13}
    else:
        d.update(num_image_embeds=4, max_seq_length=24, max_len_b=17,
                 max_pred=5)
        d["argv"] = ["--src_file", "unused", "--len_vis_input", "4",
                     "--max_seq_length", "24", "--max_len_b", "17",
                     "--max_pred", "5", "--train_batch_size", "4"] + COMMON
        lengths = {"median": 8, "sigma": 0.5, "min": 2, "max": 17}
    d["overrides"] = dict(d["overrides"], **{"bert.compute_dtype":
                                             "float32"})
    cell.traffic.update(report_wordpieces=lengths, steps_per_dispatch=2,
                        pool_batches=4)
    return cell


def cell(name: str, root=harness.ROOT) -> harness.Cell:
    bench = harness.load_json(root / "BENCHMARK.json")
    return shrink(harness.load_cell(bench, name, root))


def run(c: harness.Cell, seed: int = 2 ** 31 + 11, traced: bool = False,
        seconds: float = 0.5, fault=None):
    import time

    return harness.run_cell(c, seed, seconds, traced, time.perf_counter(),
                            device="cpu", fault=fault)
