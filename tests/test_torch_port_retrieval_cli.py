"""The port's retrieval CLI against the JAX package's on
tools/synthetic_data.py's retrieval tree (8 records, 64 px, one pool of 8
candidates; ``--num_image_embeds 4``, the trunk's 4 fibers at 64 px, so
both CLIs' sorted random-pixel draws are the identity): one epoch of each,
the same eval_results.json and rank dump from one reference-layout .bin
scored with ``--do_train false``, the ``--CXRBERT false`` branch, the
refusals, and ``--bert_init_path`` / ``--resnet_init_path`` in the port's
finetune and classification CLIs."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from medvill_torch.cli import (classification_main, finetune_main,
                               retrieval_main)
from medvill_torch.config import BertConfig as TBertConfig
from medvill_torch.config import ImageEncoderConfig as TImageConfig
from medvill_torch.convert import (load_cnn_bert_checkpoint,
                                   load_cxrbert_checkpoint, load_mmbt_checkpoint,
                                   load_vlp_checkpoint)
from medvill_torch.models.cnn_bert import CNNBert
from medvill_torch.models.cxrbert import CXRBERT
from medvill_torch.models.seq2seq import init_weights
from medvill_tpu.cli import retrieval_main as jax_retrieval_main

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

TINY = ["--bert_model", "test-tiny", "--vocab_size", "64", "--img_size",
        "64", "--num_image_embeds", "4", "--seq_len", "7", "--batch_size",
        "2", "--eval_len_size", "8"]


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    from synthetic_data import generate

    root = str(tmp_path_factory.mktemp("syn"))
    generate(root, n=8, img_size=64, seed=0)
    return root


def _argv(syn, out, *extra):
    pool = os.path.join(syn, "retrieval", "eval_pool.jsonl")
    return ["--train_dataset", os.path.join(syn, "retrieval", "train.jsonl"),
            "--label_conditioned_valid_dataset", pool,
            "--label_conditioned_test_dataset", pool,
            "--vocab_file", os.path.join(syn, "vocab.txt"),
            "--output_path", str(out), *TINY, *extra]


def _jax_main(argv):
    jax_retrieval_main.main(jax_retrieval_main.build_parser().parse_args(
        argv))


def _read(out):
    with open(os.path.join(out, "eval_results.json")) as f:
        res = json.load(f)
    assert os.path.basename(res.pop("rank_dump")) == \
        "rank_result_at_eval.json"
    with open(os.path.join(out, "rank_result_at_eval.json")) as f:
        dump = [json.loads(line) for line in f]
    return res, dump


def test_both_clis_train_one_epoch(syn, tmp_path):
    """One epoch in each CLI, the port's with --eval_during_training and
    --do_test: both train losses finite; the port writes model.0.bin in the
    CXRBERT layout (it loads strictly), metrics.jsonl with train_loss,
    train_acc, examples_per_s (2 x batch per micro-step) and the valid
    mrr, then the test row, eval_results.json with the JAX CLI's keys and
    values in [0, 1], and one rank line per query and evaluation; the
    flags and defaults are the JAX CLI's but --device (cuda by default);
    the unported flags are refused."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    # 4 pairs, 8 rows: the JAX CLI shards a batch over the pytest run's 8
    # virtual devices; its evaluation is held by the next test
    run = ("--epochs", "1", "--batch_size", "4")
    _jax_main(_argv(syn, jout, *run))
    with open(jout / "metrics.jsonl") as f:
        jrow = json.loads(f.readline())
    assert np.isfinite(jrow["train_loss"]) and 0 <= jrow["train_acc"] <= 1
    argv = _argv(syn, tout, *run, "--eval_during_training", "true",
                 "--do_test", "true", "--device", "cpu")
    out = retrieval_main.main(argv)
    row = out["epochs"][0]
    assert row["micro_steps"] == 2 and np.isfinite(row["train_loss"])
    assert 0.0 <= row["train_acc"] <= 1.0 and row["examples_per_s"] > 0
    assert row["examples_per_s"] == pytest.approx(
        2 * 4 * 2 / row["epoch_time_s"])
    with open(tout / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {"train_loss", "train_acc", "examples_per_s", "mrr",
            "candidates_per_s"} <= set(lines[0])
    assert {"mrr", "R@1", "R@5", "R@10"} <= set(lines[1])
    tres, tdump = _read(tout)
    assert set(tres) == {"hits", "mrr", "recall", "precision"}
    assert tres["hits"].keys() == {"i2t_retrieval"}
    assert 0.0 <= tres["mrr"] <= 1.0
    assert len(tdump) == 2  # one query: the valid pool, then the test
    pc = retrieval_main.config_from_args(
        retrieval_main.build_parser().parse_args(argv))
    assert load_cxrbert_checkpoint(CXRBERT(pc.bert, pc.image),
                                   str(tout / "model.0.bin")) == []
    assert retrieval_main.build_parser().parse_args(
        argv[:-2]).device == "cuda"
    for flag in ("--steps_per_dispatch", "--model_parallel", "--zero1"):
        with pytest.raises(SystemExit):
            retrieval_main.build_parser().parse_args(argv + [flag, "2"])
    jargs = vars(jax_retrieval_main.build_parser().parse_args(argv[:-2]))
    targs = vars(retrieval_main.build_parser().parse_args(argv[:-2]))
    for k in ("steps_per_dispatch", "model_parallel", "zero1"):
        del jargs[k]
    assert jargs == {k: v for k, v in targs.items() if k != "device"}


def _cxrbert_file(path):
    """A reference-layout CXRBERT file: the port's random init at the tiny
    widths, its ITM head scaled up so the candidates' scores spread."""
    model = CXRBERT(TBertConfig.test_tiny(vocab_size=64),
                    TImageConfig(img_size=64, num_image_embeds=4))
    init_weights(model, 3, initializer_range=0.2)
    with torch.no_grad():
        model.itm.linear.weight.mul_(20.0)
    torch.save(model.state_dict(), path)


def test_eval_results_equal_from_one_checkpoint(syn, tmp_path):
    """--do_train false --do_test true --load_pretrained_model <one .bin>:
    the port's eval_results.json and rank dump equal the JAX CLI's (the
    metrics are ranks, so exactly)."""
    path = str(tmp_path / "model.bin")
    _cxrbert_file(path)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    extra = ("--do_train", "false", "--do_test", "true",
             "--load_pretrained_model", path)
    _jax_main(_argv(syn, jout, *extra))
    out = retrieval_main.main(_argv(syn, tout, *extra, "--device", "cpu"))
    assert out["loaded"] == path and out["epochs"] == []
    assert _read(tout) == _read(jout)


def test_cnn_bert_branch_runs(syn, tmp_path):
    """--CXRBERT false: one epoch and the test through CNN_BERT, model.0.bin
    in the CNN_BERT layout; a second run loads it back through
    --load_pretrained_model given the run directory."""
    out = tmp_path / "cnn"
    res = retrieval_main.main(_argv(syn, out, "--epochs", "1", "--do_test",
                                    "true", "--CXRBERT", "false",
                                    "--device", "cpu"))
    assert np.isfinite(res["epochs"][0]["train_loss"])
    assert 0.0 <= res["test"]["mrr"] <= 1.0
    model = CNNBert(TBertConfig.test_tiny(vocab_size=64))
    assert load_cnn_bert_checkpoint(model, str(out / "model.0.bin")) == []
    again = retrieval_main.main(_argv(
        syn, tmp_path / "again", "--do_train", "false", "--do_test", "true",
        "--CXRBERT", "false", "--load_pretrained_model", str(out),
        "--device", "cpu"))
    assert again["loaded"] == str(out / "model.0.bin")
    assert again["test"]["mrr"] == res["test"]["mrr"]
    with pytest.raises(FileNotFoundError, match="neither"):
        retrieval_main.main(_argv(syn, tmp_path / "x", "--do_train", "false",
                                  "--load_pretrained_model",
                                  str(tmp_path / "missing"), "--device",
                                  "cpu"))


def _init_files(d):
    """(HF BERT file, torchvision ResNet-50 file) from a random tiny port
    model: 2 layers, 32 positions, the HF names; the trunk under
    torchvision names."""
    src = CXRBERT(TBertConfig.test_tiny(vocab_size=64),
                  TImageConfig(img_size=64, num_image_embeds=4))
    init_weights(src, 9, initializer_range=0.5)
    enc = src.enc.state_dict()
    hf = {"bert.embeddings." + k[len("txt_embeddings."):]: t
          for k, t in enc.items() if k.startswith("txt_embeddings.")}
    hf.update({"bert." + k: t for k, t in enc.items()
               if k.startswith(("encoder.", "pooler."))})
    pos = "bert.embeddings.position_embeddings.weight"
    hf[pos] = hf[pos][:32]
    back = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
            "6": "layer3", "7": "layer4"}
    tv = {}
    for k, t in src.enc.img_encoder.state_dict().items():
        idx, _, tail = k[len("model."):].partition(".")
        tv[f"{back[idx]}.{tail}"] = t
    hf_path, tv_path = os.path.join(d, "bert.bin"), os.path.join(d, "r.pth")
    torch.save(hf, hf_path)
    torch.save(tv, tv_path)
    return hf_path, tv_path, enc


def _check_init(sd, prefix, enc):
    """The saved model holds the files' tensors (lr 0: no update moves
    them; the trunk's running statistics move in train mode and are not
    compared); the 512-row position table repeats the file's last row."""
    for k, t in enc.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")) \
                or k.startswith("img_embeddings."):
            continue
        got = sd[prefix + k]
        if k == "txt_embeddings.position_embeddings.weight":
            assert torch.equal(got[:32], t[:32])
            assert torch.equal(got[32:], t[31:32].expand(got.shape[0] - 32,
                                                         -1))
        elif k == "txt_embeddings.token_type_embeddings.weight" \
                and got.shape[0] == 6:
            assert torch.equal(got[:2], t) and torch.equal(got[4], t[0])
        else:
            assert torch.equal(got, t), k


def test_init_paths_load_in_finetune_and_classification(syn, tmp_path):
    """--bert_init_path and --resnet_init_path in the port's finetune CLI
    (enc_key "bert": the VLP model itself, 2 token types expanded to 6)
    and classification CLI (enc_key "enc"), one epoch at lr 0: the saved
    model.0.bin holds the files' tensors."""
    hf_path, tv_path, enc = _init_files(str(tmp_path))
    vocab = os.path.join(syn, "vocab.txt")
    ft = tmp_path / "ft"
    finetune_main.main([
        "--src_file", os.path.join(syn, "reportgen", "train.jsonl"),
        "--vocab_file", vocab, "--output_dir", str(ft),
        "--bert_init_path", hf_path, "--resnet_init_path", tv_path,
        "--bert_model", "test-tiny", "--vocab_size", "64", "--img_size",
        "64", "--len_vis_input", "4", "--max_seq_length", "24",
        "--max_len_b", "17", "--max_pred", "3", "--train_batch_size", "4",
        "--num_train_epochs", "1", "--learning_rate", "0", "--device",
        "cpu"])
    cfg = finetune_main.config_from_args(finetune_main.build_parser()
                                         .parse_args(["--src_file", "s",
                                                      "--vocab_file", "v",
                                                      "--bert_model",
                                                      "test-tiny",
                                                      "--vocab_size", "64",
                                                      "--img_size", "64",
                                                      "--len_vis_input",
                                                      "4"]))
    from medvill_torch.models.seq2seq import VLPForPreTraining

    vlp = VLPForPreTraining(cfg.bert, cfg.image, len_vis_input=4)
    assert load_vlp_checkpoint(vlp, str(ft / "model.0.bin")) == []
    _check_init(vlp.state_dict(), "", enc)
    clf = tmp_path / "clf"
    out = classification_main.main([
        "--data_path", os.path.join(syn, "classification"), "--vocab_file",
        vocab, "--savedir", str(clf), "--bert_init_path", hf_path,
        "--resnet_init_path", tv_path, "--bert_model", "test-tiny",
        "--vocab_size", "64", "--img_size", "64", "--num_image_embeds", "4",
        "--max_seq_len", "20", "--batch_sz", "4", "--max_epochs", "1",
        "--lr", "0", "--device", "cpu"])
    sd = torch.load(clf / "clf" / "model.0.bin", weights_only=True)
    _check_init(sd, "enc.", enc)
    assert out["merged"] == []
    from medvill_torch.train import classify

    n = sd["clf.weight"].shape[0]
    model = classify.build_model(classification_main.config_from_args(
        classification_main.build_parser().parse_args(
            ["--data_path", "d", "--vocab_file", "v", "--bert_model",
             "test-tiny", "--vocab_size", "64", "--img_size", "64",
             "--num_image_embeds", "4", "--max_seq_len", "20"]),
        [str(i) for i in range(n)]), n)
    assert load_mmbt_checkpoint(model, str(clf / "clf" / "model.0.bin")) \
        == []
