"""The port's training CLIs on two gloo processes on the CPU
(tests/torch_parallel_worker.py ``clis``, started once by a module fixture,
one torch thread each): the pretrain CLI stopped by a flag on one rank and
relaunched, a two-rank tensor-parallel ZeRO-1 checkpoint loaded in one
process, and the classification CLI at --model_parallel 2."""
import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from medvill_torch.data.pretrain import synthetic_records
from tests.torch_port_support import launch_ranks, wait_ranks
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

WORDS = [f"word{i}" for i in range(50)]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def _cli_data(d):
    """Vocabulary, 8 pretrain records over 64-px images (the first 2 also
    the test set), classification Train/Valid/Test splits."""
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(SPECIALS + WORDS) + "\n")
    rng = np.random.default_rng(0)
    recs = synthetic_records(8, random.Random(1), words=WORDS)
    for r in recs:
        Image.fromarray(rng.integers(0, 256, (64, 64), np.uint8),
                        "L").save(os.path.join(d, r["img"]), format="PNG")
    train, test = os.path.join(d, "train.jsonl"), os.path.join(d,
                                                               "test.jsonl")
    with open(train, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
    with open(test, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs[:2]))
    for split in ("Train", "Valid", "Test"):
        with open(os.path.join(d, f"{split}.jsonl"), "w") as f:
            for i, r in enumerate(recs[:6]):
                f.write(json.dumps({"text": r["text"], "img": r["img"],
                                    "label": "'A'" if i % 2 else "'B'"})
                        + "\n")
    return {"dir": d, "vocab": vocab, "train": train, "test": test}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: [rank 0's, rank 1's]."""
    d = str(tmp_path_factory.mktemp("parallel_clis"))
    path, out = os.path.join(d, "inputs.pt"), os.path.join(d, "out")
    os.makedirs(out)
    torch.save({"data": _cli_data(d)}, path)
    return wait_ranks(launch_ranks(path, out, "clis"), out)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_a_flag_on_one_rank_stops_both_and_resumes_bit_equal(ranks):
    """The pretrain CLI on two ranks with ZeRO-1 (2 epochs of 2 batches
    per rank, accumulation 2): rank 1's flag, raised at its first poll,
    stops both ranks after the same first dispatch, mid-accumulation; the
    relaunch writes the model and optimizer files of the run never
    stopped, bit for bit (rank 0 writes them in the single-process
    format, with the ranks' summed gradients and each rank's sample
    stream)."""
    a, b = ranks[0]["preemption"], ranks[1]["preemption"]
    assert a["dispatches_before_stop"] == b["dispatches_before_stop"] == 1
    assert a["marker"] == {"epoch": 0, "batches_done": 1}
    straight, stopped = a["straight"], a["stopped"]
    for name in ("model.1.bin", "optim.1.bin"):
        _assert_equal(_load(os.path.join(stopped, name)),
                      _load(os.path.join(straight, name)), name)
    saved = _load(os.path.join(straight, "optim.1.bin"))
    assert len(saved["loader_ranks"]) == 2
    model = _load(os.path.join(straight, "model.1.bin"))
    q = model["enc.encoder.layer.0.attention.self.query.weight"]
    assert tuple(q.shape) == (32, 32)
    assert not os.path.exists(os.path.join(stopped, "preempt.json"))


def test_a_two_rank_checkpoint_loads_in_one_process(ranks):
    """The --model_parallel 2 --zero1 true run's model.0.bin and
    optim.0.bin restore into a one-process state, whose eval of the test
    records gives the eval loss the two-rank run logged (1e-5), and whose
    parameter and first-moment norms its last watch row (1e-5: the run
    gathered its slices and chunks); the
    classification CLI at --model_parallel 2 trains, reloads its best
    model for the test and writes its files from rank 0."""
    res = ranks[0]["tp_checkpoint"]
    np.testing.assert_allclose(res["reloaded_eval_loss"],
                               res["run_eval_loss"], rtol=1e-5)
    for k in ("watch/param_norm", "watch/param_norm/enc",
              "watch/grad_ema_norm"):
        np.testing.assert_allclose(res["run_watch"][k],
                                   res["reloaded_watch"][k], rtol=1e-5,
                                   err_msg=k)
    clf = ranks[0]["classification_cli"]
    assert clf["test"] == ranks[1]["classification_cli"]["test"]
    assert np.isfinite(clf["test"]["micro_f1"])
    files = os.listdir(os.path.join(clf["savedir"], "clf"))
    assert {"model.0.bin", "model.best.bin", "metrics.jsonl"} <= set(files)
