"""The port's classification data, metrics, plateau schedule, pretrain
merge, prefetching input pipeline and CLIs: the dataset's arrays, the
label scan and pos_weight, the AUROC/F1 and rank metrics, the plateau
scale and the merge of a pretrain checkpoint against the JAX package's;
PrefetchLoader's order, error surfacing, place_fn and release of its
producer on an early exit; the classification CLI end to end on the CPU
(one epoch and --do_test, --loaddir, refused flags); the pretrain and
finetune CLIs training on the same batch sequence through the prefetching
loader as through a serial one."""
import json
import os
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from medvill_torch.checkpoint import (latest_pretrain_file,
                                      merge_pretrained_into_mmbt)
from medvill_torch.cli import (classification_main, finetune_main,
                               pretrain_main)
from medvill_torch.config import BertConfig as TBertConfig
from medvill_torch.config import ClassificationConfig as TClfConfig
from medvill_torch.config import ImageEncoderConfig as TImageConfig
from medvill_torch.convert import (cxrbert_state_dict_from_flax,
                                   load_mmbt_checkpoint,
                                   mmbt_state_dict_from_flax,
                                   save_state_dict)
from medvill_torch.data import classification as tdata
from medvill_torch.data import pretrain as tpre_data
from medvill_torch.data.tokenization import BertTokenizer as TTokenizer
from medvill_torch.eval import metrics as tmetrics
from medvill_torch.train import classify as tclf
from medvill_tpu.cli.classification_main import _merge_pretrained
from medvill_tpu.core.config import (BertConfig, ClassificationConfig,
                                     ImageEncoderConfig, PretrainConfig)
from medvill_tpu.data import classification as jdata
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.eval import metrics as jmetrics
from medvill_tpu.train import classify as jclf
from medvill_tpu.train import pretrain as jpre
from tests.torch_port_support import perturb, random_batch_stats

WORDS = [f"word{i}" for i in range(50)]
LABELS = ["'A'", "'B'", "'C'", "'D'"]
TINY = ["--bert_model", "test-tiny", "--vocab_size", "64", "--img_size",
        "64"]


def write_split(d, name, recs, size=64, seed=0):
    rng = np.random.default_rng(seed)
    with open(os.path.join(d, f"{name}.jsonl"), "w") as f:
        for r in recs:
            r = dict(r, img=f"{name}_{r['img'].replace('.jpg', '.png')}")
            Image.fromarray(rng.integers(0, 256, (size, size), np.uint8),
                            "L").save(os.path.join(d, r["img"]))
            f.write(json.dumps(r) + "\n")
    return os.path.join(d, f"{name}.jsonl")


def write_vocab(d):
    path = os.path.join(d, "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(list(build_vocab(WORDS))) + "\n")
    return path


@pytest.mark.parametrize("task_type,drop", [("multilabel", 0.0),
                                            ("multilabel", 0.5),
                                            ("classification", 0.0)])
def test_dataset_matches_jax(tmp_path, task_type, drop):
    """Every array of every example equal to JAX's: the text window
    (tokens[:max - N - 1] + [SEP], padded), txt_len, segment 1, the
    multi-hot label with 'Others' (or the class index), the image (the gray
    placeholder where drop_img_percent dropped it, under numpy_seed(0))."""
    recs = jdata.synthetic_clf_records(12, LABELS, seed=3)
    recs[2]["label"] = ""
    if task_type == "classification":
        for i, r in enumerate(recs):
            r["label"] = LABELS[i % 4]
    path = write_split(str(tmp_path), "Train", recs, size=32)
    labels, freqs = jdata.get_labels_and_frequencies(path)
    t_labels, t_freqs = tdata.get_labels_and_frequencies(path)
    assert (t_labels, t_freqs) == (labels, freqs)
    np.testing.assert_array_equal(tdata.pos_weights(t_freqs, t_labels, 12),
                                  jdata.pos_weights(freqs, labels, 12))
    vocab = build_vocab(WORDS)
    kw = dict(max_seq_len=16, num_image_embeds=4, img_size=32,
              drop_img_percent=drop, task_type=task_type)
    want = jdata.ClassificationDataset(path, BertTokenizer(vocab), labels,
                                       **kw)
    state = np.random.get_state()[1].copy()
    got = tdata.ClassificationDataset(path, TTokenizer(vocab), labels, **kw)
    np.testing.assert_array_equal(np.random.get_state()[1], state)
    assert len(got) == len(want) == 12
    gray = 0
    for i in range(12):
        w, g = want[i], got[i]
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        gray += bool((g["image"] == 128).all())
    assert (gray > 0) == (drop > 0)


def test_metrics_match_jax():
    """classification_metrics (mid-rank AUROC with ties, a class with one
    label value -> nan, micro/macro F1) and the rank metrics, equal."""
    rng = np.random.default_rng(0)
    logits = np.round(rng.normal(size=(40, 5)), 1)  # ties
    labels = (rng.random((40, 5)) < 0.4).astype(np.float32)
    labels[:, 3] = 1.0
    got = tmetrics.classification_metrics(logits, labels)
    want = jmetrics.classification_metrics(logits, labels)
    assert got.keys() == want.keys()
    for k in ("micro_roc_auc", "macro_roc_auc", "micro_f1", "macro_f1"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(list(got["per_class_auroc"].values()),
                                  list(want["per_class_auroc"].values()))
    assert np.isnan(got["per_class_auroc"]["3"])
    sims = rng.normal(size=(6, 20))
    align = (rng.random((6, 20)) < 0.2).astype(int)
    assert tmetrics.compute_ranks(sims, align) == \
        jmetrics.compute_ranks(sims, align)
    assert tmetrics.evaluate_retrieval(sims, align) == \
        jmetrics.evaluate_retrieval(sims, align)


def test_plateau_scheduler_matches_jax():
    metrics = [0.5, 0.6, 0.6, 0.55, 0.59, 0.7, 0.1, 0.1, 0.1, 0.1, 0.8]
    for factor, patience in ((0.5, 2), (0.1, 0), (0.5, 1)):
        j, t = (jclf.PlateauScheduler(factor, patience),
                tclf.PlateauScheduler(factor, patience))
        assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]


def _jax_params(model, args, key):
    v = jax.jit(lambda k: model.init({"params": k}, *args))(
        jax.random.PRNGKey(key))
    rng = np.random.default_rng(key)
    return perturb(v["params"], rng, 0.05), random_batch_stats(
        v["batch_stats"], rng)


def test_pretrain_merge_matches_jax(tmp_path):
    """A pretrain checkpoint (CXRBERT layout) merged into the MMBT model:
    every enc.* parameter and BatchNorm statistic taken, the head kept,
    equal to the JAX CLI's _merge_pretrained, tensor for tensor."""
    bert = BertConfig.test_tiny(vocab_size=64)
    image = ImageEncoderConfig(img_size=64, num_image_embeds=4,
                               encoder="full-fiber")
    pcfg = PretrainConfig(seq_len=7, bert=bert, image=image)
    pre_params, pre_stats = _jax_params(jpre.build_model(pcfg), (
        jnp.zeros((2, 1), jnp.int32), jnp.zeros((2, 8), jnp.int32),
        jnp.zeros((2, 2), jnp.int32), jnp.ones((2, 8), jnp.int32),
        jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1), jnp.int32)), 1)
    ccfg = ClassificationConfig(bert=bert, image=image, num_image_embeds=4,
                                max_seq_len=16, img_size=64)
    clf_params, clf_stats = _jax_params(jclf.build_model(ccfg, 3), (
        jnp.zeros((2, 12), jnp.int32), jnp.ones((2,), jnp.int32),
        jnp.ones((2, 12), jnp.int32), jnp.zeros((2, 64, 64, 3)), 2, 3), 2)
    want_p, want_s = _merge_pretrained(
        clf_params, clf_stats, {"params": pre_params,
                                "batch_stats": pre_stats})
    want = mmbt_state_dict_from_flax(want_p, want_s)

    path = str(tmp_path / "model.3.bin")
    save_state_dict(cxrbert_state_dict_from_flax(pre_params, pre_stats),
                    path)
    save_state_dict({}, str(tmp_path / "model.1.bin"))
    assert latest_pretrain_file(str(tmp_path)) == path
    tcfg = TClfConfig(bert=TBertConfig.test_tiny(vocab_size=64),
                      image=TImageConfig(img_size=64, num_image_embeds=4,
                                         encoder="full-fiber"))
    model = tclf.build_model(tcfg, 3)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           mmbt_state_dict_from_flax(clf_params,
                                                     clf_stats).items()})
    merged = merge_pretrained_into_mmbt(model, path)
    assert merged == sorted(k for k in model.state_dict()
                            if k.startswith("enc.")
                            and not k.endswith("num_batches_tracked"))
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="model.<epoch>.bin"):
        latest_pretrain_file(str(tmp_path / "nothing"))


def test_prefetch_loader_order_error_and_place_fn():
    batches = [{"x": np.array([i])} for i in range(5)]
    out = [b["x"][0] for b in tpre_data.PrefetchLoader(batches, depth=2)]
    assert out == [0, 1, 2, 3, 4]
    assert len(tpre_data.PrefetchLoader(batches)) == 5

    def bad():
        yield {"x": np.array([0])}
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(tpre_data.PrefetchLoader(bad()))
    seen = []
    out = list(tpre_data.PrefetchLoader(
        batches, place_fn=lambda b: (seen.append(1), b)[1]))
    assert len(out) == 5 and len(seen) == 5
    placed = list(tpre_data.dispatch_loader(
        [{"x": np.arange(3), "y": np.ones(2)}] * 2, "cpu", keys=("x",)))
    assert [set(b) for b in placed] == [{"x"}, {"x"}]
    assert all(isinstance(b["x"], torch.Tensor) for b in placed)


def test_prefetch_loader_releases_producer_on_early_exit():
    """Abandoning the iterator mid-epoch leaves no producer thread blocked
    on a full queue holding prefetched batches."""
    produced = []

    def slow_batches():
        for i in range(50):
            produced.append(i)
            yield {"x": np.full((2,), i)}

    before = threading.active_count()
    it = iter(tpre_data.PrefetchLoader(slow_batches(), depth=1))
    assert next(it)["x"][0] == 0
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"
    assert len(produced) < 50, "producer ran the whole epoch after abandon"


def _clf_fixture(d):
    recs = tdata.synthetic_clf_records(20, LABELS, seed=0)
    for name, part, seed in (("Train", recs[:8], 0), ("Valid", recs[8:14], 1),
                             ("Test", recs[14:], 2)):
        write_split(d, name, part, seed=seed)
    return write_vocab(d)


CLF_ARGS = TINY + ["--num_image_embeds", "4", "--max_seq_len", "20",
                   "--batch_sz", "4", "--device", "cpu"]


def test_classification_cli_end_to_end_on_cpu(tmp_path):
    """One epoch plus --do_test from a --loaddir of pretrain checkpoints:
    the merge, a finite train loss and metrics, the CSV, model.0.bin and
    model.best.bin in the MMBT layout (loading strictly), metrics.jsonl
    with the throughput field and the test row; --device defaults to cuda;
    the unported flags are refused, and a --loaddir without checkpoints
    raises."""
    d = str(tmp_path)
    vocab = _clf_fixture(d)
    pre = tmp_path / "pre"
    pre.mkdir()
    pdata = write_split(d, "pretrain", [dict(r, split="train") for r in
                        tpre_data.synthetic_records(4, random.Random(0),
                                                    words=WORDS)])
    pretrain_main.main(["--train_dataset", pdata, "--vocab_file", vocab,
                        "--output_path", str(pre), "--num_image_embeds", "3",
                        "--seq_len", "12", "--batch_size", "2", "--epochs",
                        "1", *TINY, "--device", "cpu"])
    argv = ["--data_path", d, "--vocab_file", vocab, "--savedir",
            str(tmp_path / "out"), "--loaddir", str(pre), "--max_epochs", "1",
            "--do_test", "true", *CLF_ARGS]
    out = classification_main.main(argv)
    row = out["epochs"][0]
    assert len(out["merged"]) > 300
    assert row["micro_steps"] == 2 and np.isfinite(row["train_loss"])
    assert row["examples_per_s"] > 0 and np.isfinite(row["micro_f1"])
    assert np.isfinite(out["test"]["micro_f1"])
    run = tmp_path / "out" / "clf"
    assert {"clf.csv", "model.0.bin", "model.best.bin", "metrics.jsonl",
            "logfile.log"} <= set(os.listdir(run))
    with open(run / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["epoch"] == 0 and "examples_per_s" in lines[0]
    assert set(lines[1]) == {"test"}
    with open(run / "clf.csv") as f:
        header = f.readline().strip().split(",")
    assert header[:4] == ["micro_auc", "macro_auc", "micro_f1", "macro_f1"]
    args = classification_main.build_parser().parse_args(argv)
    labels, _ = tdata.get_labels_and_frequencies(os.path.join(d,
                                                              "Train.jsonl"))
    model = tclf.build_model(classification_main.config_from_args(
        args, labels), len(labels))
    assert load_mmbt_checkpoint(model, str(run / "model.best.bin")) == []
    assert classification_main.build_parser().parse_args(
        argv[:-2]).device == "cuda"
    for flag in ("--steps_per_dispatch", "--model_parallel"):
        with pytest.raises(SystemExit):
            classification_main.build_parser().parse_args(argv + [flag, "1"])
    with pytest.raises(FileNotFoundError):
        classification_main.main(argv[:4] + ["--savedir", str(tmp_path / "x"),
                                             "--loaddir", d] + CLF_ARGS)


def test_classification_cli_freeze_all_and_task_type():
    """--freeze_*_all false freezes for every epoch (the reference's
    inverted assignment); --num_image_embeds 1-9 selects the pool encoder;
    the CLI's defaults are the JAX CLI's."""
    argv = ["--data_path", "d", "--vocab_file", "v"]
    args = classification_main.build_parser().parse_args(
        argv + ["--freeze_img_all", "false", "--num_image_embeds", "5",
                "--max_epochs", "7", "--img_embed_pool_type", "max"])
    cfg = classification_main.config_from_args(args, LABELS)
    assert (cfg.freeze_img, cfg.freeze_txt) == (7, 0)
    assert (cfg.image.encoder, cfg.image.pool_type) == ("pool", "max")
    from medvill_tpu.cli.classification_main import build_parser
    jargs = vars(build_parser().parse_args(argv))
    targs = vars(classification_main.build_parser().parse_args(argv))
    unported = {"steps_per_dispatch", "model_parallel", "zero1"}
    assert {k: v for k, v in jargs.items() if k not in unported} == \
        {k: v for k, v in targs.items() if k != "device"}


def _record_batches(monkeypatch, module, serial: bool) -> list:
    """The batches the CLI's train step sees; with ``serial`` the
    prefetching pipeline is replaced by a loop that fetches and copies."""
    seen = []
    if serial:
        monkeypatch.setattr(module, "dispatch_loader", lambda loader, device,
                            keys=None: ({k: torch.as_tensor(v) for k, v in
                                         b.items() if keys is None
                                         or k in keys} for b in loader))
    make = module.make_train_step if module is pretrain_main else \
        module.ft.make_train_step

    def wrap(*a, **k):
        step = make(*a, **k)

        def recorded(state, batch, generator):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch, generator)

        return recorded

    if module is pretrain_main:
        monkeypatch.setattr(module, "make_train_step", wrap)
    else:
        monkeypatch.setattr(module.ft, "make_train_step", wrap)
    return seen


@pytest.mark.parametrize("cli", ["pretrain", "finetune"])
def test_training_clis_prefetch_the_serial_batch_sequence(tmp_path,
                                                          monkeypatch, cli):
    """Two epochs through dispatch_loader give the train step the same
    batches in the same order, and the same losses, as the serial
    pipeline (one loader worker: one sequential RNG stream)."""
    d = str(tmp_path)
    vocab = write_vocab(d)
    data = write_split(d, "train", [dict(r, split="train") for r in
                       tpre_data.synthetic_records(6, random.Random(1),
                                                   words=WORDS)])
    if cli == "pretrain":
        module = pretrain_main
        argv = ["--train_dataset", data, "--num_image_embeds", "3",
                "--seq_len", "12", "--batch_size", "2", "--num_workers", "1"]
    else:
        module = finetune_main
        argv = ["--src_file", data, "--len_vis_input", "4",
                "--max_seq_length", "24", "--max_len_b", "17", "--max_pred",
                "3", "--train_batch_size", "2"]
    runs = []
    for serial in (True, False):
        with monkeypatch.context() as m:
            seen = _record_batches(m, module, serial)
            out = str(tmp_path / f"run_{serial}")
            result = module.main(argv + [
                "--vocab_file", vocab, *TINY, "--device", "cpu",
                "--output_path" if cli == "pretrain" else "--output_dir",
                out, "--epochs" if cli == "pretrain" else
                "--num_train_epochs", "2"])
        rows = result if cli == "pretrain" else result["epochs"]
        runs.append((seen, [r.get("avg_loss", r.get("loss")) for r in rows]))
    (serial_b, serial_l), (pre_b, pre_l) = runs
    assert len(serial_b) == len(pre_b) == 6
    for a, b in zip(serial_b, pre_b):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert serial_l == pre_l
