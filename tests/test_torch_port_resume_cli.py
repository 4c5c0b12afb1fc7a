"""The port's training state, resume and preemption on the CPU: the
optimizer state's round trip, the resume scan, and the pretrain, finetune
and classification CLIs preempted by a counting guard and relaunched (the
pretrain and finetune runs bit for bit equal to an uninterrupted twin),
the pretrain CLI's torch-file initializers, its eval, watch rows and
profile trace.  The JAX package has the same checks in
tests/test_preempt.py; what is held against JAX directly is in
test_torch_port_resume.py."""
import json
import os
import random
import signal

import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from medvill_torch import checkpoint as ckpt
from medvill_torch import torch_init
from medvill_torch.cli import (classification_main, finetune_main,
                               pretrain_main)
from medvill_torch.data.pretrain import synthetic_records
from medvill_torch.train import classify
from medvill_torch.train import optim
from medvill_torch.train import pretrain as tpre
from medvill_torch.utils import preempt

WORDS = [f"word{i}" for i in range(50)]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


class _CountingGuard:
    """Stands in for ``PreemptionGuard``: triggered from the
    ``polls_until_trigger``-th read on (tests/test_preempt.py:150-170)."""

    polls_until_trigger = 3

    def __init__(self, logger=None):
        self.polls = 0
        self.signum = signal.SIGTERM

    @property
    def triggered(self):
        self.polls += 1
        return self.polls >= self.polls_until_trigger

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _preempted(monkeypatch, polls: int, run):
    """``run()`` under a guard triggered at its ``polls``-th read."""
    guard = type("Guard", (_CountingGuard,), {"polls_until_trigger": polls})
    with monkeypatch.context() as m:
        m.setattr(preempt, "PreemptionGuard", guard)
        return run()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny CLI runs here take the same time on one intra-op thread and
    half the CPU time of the default, which the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Vocabulary, 6 pretrain/report records over 64-px images (the first
    2 also as a test set), and a classification split directory."""
    d = tmp_path_factory.mktemp("data")
    vocab = str(d / "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(SPECIALS + WORDS) + "\n")
    rng = np.random.default_rng(0)
    recs = synthetic_records(6, random.Random(1), words=WORDS)
    for r in recs:
        Image.fromarray(rng.integers(0, 256, (64, 64), np.uint8),
                        "L").save(str(d / r["img"]), format="PNG")
    train, test = str(d / "train.jsonl"), str(d / "test.jsonl")
    with open(train, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs))
    with open(test, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in recs[:2]))
    for split in ("Train", "Valid"):
        with open(d / f"{split}.jsonl", "w") as f:
            for i, r in enumerate(recs):
                f.write(json.dumps({"text": r["text"], "img": r["img"],
                                    "label": "'A'" if i % 2 else "'B'"})
                        + "\n")
    return {"dir": str(d), "vocab": vocab, "train": train, "test": test}


def _pretrain_argv(data, out, k=1, *extra):
    """3 batches of 2 an epoch, accumulation 2, one sample stream
    (--num_workers 1), the eval on one batch of the test records."""
    return ["--train_dataset", data["train"], "--vocab_file", data["vocab"],
            "--output_path", out, "--bert_model", "test-tiny",
            "--vocab_size", "64", "--img_size", "64", "--num_image_embeds",
            "3", "--seq_len", "12", "--batch_size", "2", "--epochs", "2",
            "--gradient_accumulation_steps", "2", "--num_workers", "1",
            "--lr", "1e-3", "--device", "cpu", "--log_freq", "1",
            "--steps_per_dispatch", str(k), "--test_dataset", data["test"],
            *extra]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal(a, b, where=""):
    """Nested state dicts and lists equal, tensors bit for bit."""
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


def _assert_same_run(got: str, want: str, epoch: int) -> None:
    for name in (f"model.{epoch}.bin", f"optim.{epoch}.bin"):
        _assert_equal(_load(os.path.join(got, name)),
                      _load(os.path.join(want, name)), name)


def _rows(out: str, prefix: str) -> list:
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k.startswith(prefix)} for line in f]


@pytest.fixture(scope="module")
def pretrain_twins(data, tmp_path_factory):
    """k -> the output directory of an uninterrupted 2-epoch run (k = 1
    with --profile_dir and --watch_interval 2)."""
    d = tmp_path_factory.mktemp("twins")
    out = {}
    for k in (1, 2):
        out[k] = str(d / f"k{k}")
        extra = (["--profile_dir", str(d / "trace"), "--watch_interval",
                  "2"] if k == 1 else [])
        pretrain_main.main(_pretrain_argv(data, out[k], k, *extra))
    return out


def test_pretrain_twin_writes_its_eval_watch_rows_and_trace(pretrain_twins,
                                                            tmp_path):
    """The uninterrupted run: one metrics row per epoch with the eval's
    JAX keys, watch rows every 2 dispatches, the profile of dispatches 2-4
    as a Chrome trace, both files of each epoch; k = 1 and k = 2 equal."""
    out = pretrain_twins[1]
    evals = _rows(out, "eval_")
    assert len(evals) == 2 and all(
        {"eval_avg_loss", "eval_avg_mlm_loss", "eval_avg_itm_correct",
         "eval_batches"} <= set(r) and r["eval_batches"] == 1
        for r in evals)
    assert evals[0] != evals[1]  # the weights moved, the inputs did not
    with open(os.path.join(out, pretrain_main.WATCH_FILE)) as f:
        watch = [json.loads(line) for line in f]
    assert [r["step"] for r in watch] == [0, 2, 10 ** 6, 10 ** 6 + 2]
    assert all(r["watch/param_norm"] > 0 for r in watch)
    assert watch[0]["watch/grad_ema_norm"] == 0.0 < watch[-1][
        "watch/grad_ema_norm"]
    trace = os.path.join(os.path.dirname(out), "trace",
                         pretrain_main.TRACE_FILE)
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    assert ckpt.latest_epoch(out) == 1
    _assert_same_run(pretrain_twins[2], out, 1)


@pytest.mark.parametrize("k", [1, 2])
def test_pretrain_preempted_mid_accumulation_resumes_bit_exact(
        k, data, pretrain_twins, tmp_path, monkeypatch):
    """Preempted in epoch 1 with one of two micro-batches accumulated (k =
    1: after 2 dispatches; k = 2: after the first group, epoch 0's tail
    batch having trained alone), relaunched with the same argv: the marker
    is consumed, and model.1.bin and optim.1.bin (the optimizer, its
    gradients, the generator, the loader and its sample stream) and the
    eval rows equal the uninterrupted run's bit for bit."""
    out = str(tmp_path / "run")
    argv = _pretrain_argv(data, out, k)
    # polls: one per dispatch and one at each epoch's end but the last
    polls = 6 if k == 1 else 4
    _preempted(monkeypatch, polls, lambda: pretrain_main.main(argv))
    assert preempt.read_marker(out) == {"epoch": 1, "batches_done": 2}
    saved = _load(os.path.join(out, "optim.1.bin"))
    assert saved["tx"]["count"] == 1 and saved["tx"]["grads"] is not None
    assert saved["loader"]["epoch"] == 1
    rows = pretrain_main.main(argv)
    assert [r["epoch"] for r in rows] == [1] and rows[0]["micro_steps"] == 1
    assert preempt.read_marker(out) is None
    with open(os.path.join(out, "train.log")) as f:
        assert "resuming preempted run" in f.read()
    _assert_same_run(out, pretrain_twins[k], 1)
    _assert_same_run(out, pretrain_twins[k], 0)
    assert _rows(out, "eval_avg") == _rows(pretrain_twins[k], "eval_avg")


@pytest.mark.parametrize("polls", [3, 4],
                         ids=["after-the-last-dispatch", "in-eval-or-save"])
def test_pretrain_preempted_at_the_epoch_end(polls, data, pretrain_twins,
                                             tmp_path, monkeypatch):
    """A marker that covers epoch 0 (the poll after its last dispatch, or
    the one after its eval and save) resumes at epoch 1, which equals the
    uninterrupted run's bit for bit."""
    out = str(tmp_path / "run")
    argv = _pretrain_argv(data, out, 1)
    _preempted(monkeypatch, polls, lambda: pretrain_main.main(argv))
    assert preempt.read_marker(out) == {"epoch": 0, "batches_done": 3}
    rows = pretrain_main.main(argv)
    assert [r["epoch"] for r in rows] == [1] and rows[0]["micro_steps"] == 3
    _assert_same_run(out, pretrain_twins[1], 1)


def test_pretrain_run_directory_and_torch_files_initialize(
        data, pretrain_twins, tmp_path, caplog):
    """--pre_trained_model_path as a run directory restores the whole state
    of its latest epoch (lr 0 keeps the weights, AdamW's step moves on); a
    path that is neither a file nor such a directory raises;
    --hf_bert_checkpoint (alias --bert_init_path) and --resnet_init_path
    set the weights ``torch_init`` sets, and the random-trunk warning
    (shown without a trunk source: test_torch_port_pretrain_data.py) is
    not given."""
    def argv(out, *extra):
        return _pretrain_argv(data, out, 1, "--epochs", "1", "--lr", "0",
                              *extra)

    out = str(tmp_path / "warm")
    pretrain_main.main(argv(out, "--weight_load", "true",
                            "--pre_trained_model_path", pretrain_twins[1]))
    want = _load(os.path.join(pretrain_twins[1], "model.1.bin"))
    got = _load(os.path.join(out, "model.0.bin"))
    for k, v in want.items():
        if "running_" not in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    steps = [s["step"] for s in _load(os.path.join(out, "optim.0.bin"))[
        "tx"]["state"]]
    # 3 micro-steps at accumulation 2 from a count of 0: one update
    assert steps[0] == _load(os.path.join(pretrain_twins[1], "optim.1.bin"))[
        "tx"]["state"][0]["step"] + 1
    with pytest.raises(FileNotFoundError, match="neither"):
        pretrain_main.main(argv(str(tmp_path / "x"), "--weight_load", "true",
                                "--pre_trained_model_path",
                                str(tmp_path / "nothing")))

    cfg = pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv(out)))
    src = tpre.build_model(cfg)
    gen = torch.Generator().manual_seed(4)
    for t in src.state_dict().values():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen))
    enc = src.enc.state_dict()
    hf = {"bert.embeddings." + k[len("txt_embeddings."):]: t
          for k, t in enc.items() if k.startswith("txt_embeddings.")}
    hf.update({"bert." + k: t for k, t in enc.items()
               if k.startswith(("encoder.", "pooler."))})
    back = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
            "6": "layer3", "7": "layer4"}
    tv = {}
    for k, t in src.enc.img_encoder.state_dict().items():
        idx, _, tail = k[len("model."):].partition(".")
        tv[f"{back[idx]}.{tail}"] = t
    files = {"bert": str(tmp_path / "pytorch_model.bin"),
             "resnet": str(tmp_path / "resnet50.pth")}
    torch.save(hf, files["bert"])
    torch.save(tv, files["resnet"])
    out = str(tmp_path / "init")
    with caplog.at_level("INFO", logger="medvill_torch"):
        pretrain_main.main(argv(out, "--bert_init_path", files["bert"],
                                "--resnet_init_path", files["resnet"]))
    assert "randomly" not in caplog.text
    want = tpre.init_state(cfg, device="cpu").model
    torch_init.init_bert_from_torch(want, files["bert"], enc_key="enc",
                                    num_layers=cfg.bert.num_hidden_layers)
    torch_init.init_resnet_from_torch(want, files["resnet"])
    got = _load(os.path.join(out, "model.0.bin"))
    for k, p in want.named_parameters():
        assert torch.equal(got[k], p.detach()), k
    assert pretrain_main.build_parser().parse_args(
        argv(out, "--bert_init_path", "f")).hf_bert_checkpoint == "f"


def _finetune_argv(data, out, epochs=2):
    """3 batches of 2 an epoch, accumulation 2, one sample stream, k 2,
    the drop-worst ratio from epoch 1."""
    return ["--src_file", data["train"], "--vocab_file", data["vocab"],
            "--output_dir", out, "--bert_model", "test-tiny",
            "--vocab_size", "64", "--img_size", "64", "--len_vis_input", "4",
            "--max_seq_length", "24", "--max_len_b", "17", "--max_pred", "3",
            "--train_batch_size", "2", "--learning_rate", "1e-3",
            "--num_train_epochs", str(epochs),
            "--gradient_accumulation_steps", "2", "--steps_per_dispatch",
            "2", "--drop_after", "1", "--max_drop_worst_ratio", "0.2",
            "--device", "cpu"]


def test_finetune_reenters_the_marked_epoch_and_scans_on(data, tmp_path,
                                                        monkeypatch):
    """Preempted after the first group of epoch 1 (the drop-worst epoch):
    the relaunch re-enters epoch 1 at host batch 2 and ends bit for bit as
    the uninterrupted run; a relaunch for 3 epochs resumes by scan at
    epoch 2; a model.N.bin with no optim.N.bin (an older run's) and a
    leftover temporary file are not picked."""
    twin, out = str(tmp_path / "twin"), str(tmp_path / "run")
    finetune_main.main(_finetune_argv(data, twin))
    # polls: 2 dispatches in epoch 0 (a group and the tail), then epoch 1's
    # first
    _preempted(monkeypatch, 3,
               lambda: finetune_main.main(_finetune_argv(data, out)))
    assert preempt.read_marker(out) == {"epoch": 1, "batches_done": 2}
    rows = finetune_main.main(_finetune_argv(data, out))["epochs"]
    assert [(r["epoch"], r["micro_steps"], r["drop_worst_ratio"])
            for r in rows] == [(1, 1, 0.2)]
    with open(os.path.join(out, "training.log")) as f:
        assert "re-entering epoch 1 at host batch 2" in f.read()
    assert preempt.read_marker(out) is None
    _assert_same_run(out, twin, 1)
    for name in ("model.7.bin", "optim.9.bin.tmp.1", "model.9.bin"):
        open(os.path.join(out, name), "w").close()
    assert ckpt.latest_epoch(out) == 1
    rows = finetune_main.main(_finetune_argv(data, out, epochs=3))["epochs"]
    assert [r["epoch"] for r in rows] == [2]
    assert ckpt.latest_epoch(out) == 2


def test_classification_preemption_saves_the_epoch(data, tmp_path,
                                                   monkeypatch):
    """Save-only: the poll after the first batch writes model.0.bin, which
    holds the in-memory weights, and the CLI returns with no epoch done."""
    states = []
    init = classify.init_state
    monkeypatch.setattr(classify, "init_state",
                        lambda *a, **kw: states.append(init(*a, **kw))
                        or states[-1])
    savedir = str(tmp_path / "clf")
    result = _preempted(monkeypatch, 1, lambda: classification_main.main([
        "--data_path", data["dir"], "--vocab_file", data["vocab"],
        "--savedir", savedir, "--bert_model", "test-tiny", "--vocab_size",
        "64", "--img_size", "64", "--num_image_embeds", "4",
        "--max_seq_len", "20", "--batch_sz", "2", "--max_epochs", "2",
        "--device", "cpu"]))
    assert result["epochs"] == [] and result["test"] is None
    run = os.path.join(savedir, "clf")
    assert sorted(os.listdir(run)) == ["logfile.log", "model.0.bin"]
    saved = _load(os.path.join(run, "model.0.bin"))
    own = states[0].model.state_dict()
    assert saved.keys() == own.keys()
    for k, v in own.items():
        assert torch.equal(saved[k], v), k


def _tiny_model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(4, 3), nn.LayerNorm(3))


@pytest.mark.parametrize("kind", ["adamw", "bertadam"])
def test_optimizer_state_round_trip(kind, tmp_path):
    """An ``Accumulate`` (every 2) saved after each of 5 micro-steps through
    ``torch.save``/``torch.load(weights_only=True)`` into a fresh model and
    optimizer gives the next steps of the run that never stopped, bit for
    bit; loading in place keeps the tensors (the ``.grad`` buffers and the
    moments a graph reads); another optimizer is refused."""
    def make():
        model = _tiny_model()
        if kind == "adamw":
            opt = optim.adamw(model.parameters(), 1e-2, weight_decay=0.1)
        else:
            opt = optim.BertAdam(optim.decay_groups(model, 0.01), 1e-2,
                                 t_total=4, warmup=0.5)
        return model, optim.Accumulate(opt, 2)

    xs = torch.randn(7, 5, 4, generator=torch.Generator().manual_seed(1))

    def step(model, tx, x):
        model(x).pow(2).sum().backward()
        tx.step()

    model, tx = make()
    for x in xs:
        step(model, tx, x)
    want = [p.detach().clone() for p in model.parameters()]
    for stop in range(1, 6):
        model, tx = make()
        for x in xs[:stop]:
            step(model, tx, x)
        path = str(tmp_path / "tx.bin")
        torch.save({"model": model.state_dict(), "tx": tx.state_dict()}, path)
        saved = _load(path)
        model, tx = make()
        model.load_state_dict(saved["model"])
        tx.load_state_dict(saved["tx"])
        assert tx.count == stop % 2
        for x in xs[stop:]:
            step(model, tx, x)
        for a, b in zip(model.parameters(), want):
            assert torch.equal(a, b), stop
    tx.keep_grads = True
    tensors = [t for s in tx.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t)]
    grads = [p.grad for p in model.parameters()]
    tx.load_state_dict(saved["tx"])
    assert all(a is b for a, b in zip(tensors, [
        t for s in tx.optimizer.state.values() for t in s.values()
        if torch.is_tensor(t)]))
    assert all(p.grad is g for p, g in zip(model.parameters(), grads))
    other = optim.Accumulate(optim.adamw(_tiny_model()[:1].parameters(),
                                         1e-2), 2)
    with pytest.raises(ValueError):
        other.load_state_dict(saved["tx"])


def test_latest_epoch_needs_both_files(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_epoch(d) is None
    assert ckpt.latest_epoch(str(tmp_path / "missing")) is None
    for name in ("model.0.bin", "optim.0.bin", "model.3.bin",
                 "optim.3.bin.tmp.12", "optim.5.bin", "model.x.bin"):
        open(os.path.join(d, name), "w").close()
    assert ckpt.latest_epoch(d) == 0
