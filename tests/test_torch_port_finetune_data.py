"""The port's finetune host side, checkpoint remaps and entry point: the
report-generation and VQA datasets against the JAX package's batches (byte
for byte, from the same records and seed), the pair truncation, the
token-type and position-table remaps, a pretrain checkpoint recovered into
the finetune model against the JAX recover path tensor for tensor, and the
finetune CLI end to end on the CPU for both tasks: a pretrain checkpoint
written by the port's pretrain CLI is recovered, trained on, written in
the reference VLP layout and served by the port's serve_main."""
import dataclasses
import json
import logging
import os
import pickle
import random

import jax
import numpy as np
import pytest
import torch

from medvill_torch import checkpoint as tckpt
from medvill_torch import config as tcfg
from medvill_torch.cli import (finetune_main, pretrain_main, serve_main,
                               window_positions)
from medvill_torch.convert import (cxrbert_state_dict_from_flax,
                                   load_vlp_checkpoint, save_state_dict,
                                   vlp_state_dict_from_flax)
from medvill_torch.data import pretrain as tpre_data
from medvill_torch.data import sampling as tsampling
from medvill_torch.data import seq2seq as tseq
from medvill_torch.data import vqa as tvqa
from medvill_torch.data.tokenization import BertTokenizer as TTokenizer
from medvill_torch.models.seq2seq import VLPForPreTraining
from medvill_torch.train import finetune as tft
from medvill_tpu.cli.finetune_main import _torch_pretrain_to_vlp_sd
from medvill_tpu.core import checkpoint as jckpt
from medvill_tpu.core import torch_init
from medvill_tpu.core.config import (BertConfig, FinetuneConfig,
                                     ImageEncoderConfig)
from medvill_tpu.data import pretrain as jpre_data
from medvill_tpu.data import sampling as jsampling
from medvill_tpu.data import seq2seq as jseq
from medvill_tpu.data import vqa as jvqa
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from tests.torch_port_support import IMG, VIS, VOCAB, finetune_config, jax_vlp
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

WORDS = [f"word{i}" for i in range(VOCAB - 5)]
ANSWERS = 7


def _cfgs(**kw):
    jcfg = FinetuneConfig(
        bert=BertConfig.vlp(BertConfig.test_tiny(VOCAB)),
        image=ImageEncoderConfig(img_size=IMG, num_image_embeds=VIS,
                                 encoder="full-fiber"),
        len_vis_input=VIS, max_seq_length=24, max_len_b=12, max_pred=3,
        img_size=IMG, vqa_num_answers=ANSWERS, **kw)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
         if f.name != "mesh_shape"}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(jcfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(jcfg.image))
    return jcfg, tcfg.FinetuneConfig(**d)


def _image_loader(path):
    """A deterministic image per path, the same for both loaders."""
    seed = int(path[3:-4])
    return np.random.default_rng(seed).integers(0, 256, (IMG, IMG, 3),
                                                dtype=np.uint8)


def _assert_same_batches(jl, tl, epochs=2):
    assert len(jl) == len(tl)
    try:
        for _ in range(epochs):  # the shuffle and the RNGs move on
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == len(tl)
            for a, b in zip(jb, tb):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        tl.close()


FLAGS = {"s2s": dict(),
         "mixed": dict(s2s_prob=0.6, bi_prob=0.4, bar=True,
                       new_segment_ids=False),
         "tail": dict(always_truncate_tail=True, trunc_seg=None)}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_img2txt_batches_match_jax(workers, flags):
    """Reports of 5-30 words against a 12-token text cap: truncation on
    both ends, 3 masked positions, the forced final [SEP]."""
    jcfg, pcfg = _cfgs(**FLAGS[flags])
    vocab = build_vocab(WORDS)
    recs = jpre_data.synthetic_records(18, random.Random(3), words=WORDS)
    jl = jpre_data.BatchLoader(
        jseq.Img2TxtDataset(recs, BertTokenizer(vocab), jcfg, seed=5,
                            image_loader=_image_loader),
        4, shuffle=True, seed=7, workers=workers)
    tl = tpre_data.BatchLoader(
        tseq.Img2TxtDataset(recs, TTokenizer(vocab), pcfg, seed=5,
                            image_loader=_image_loader),
        4, shuffle=True, seed=7, workers=workers)
    _assert_same_batches(jl, tl)


def _write_vqa_root(root, n_train=8, n_test=6, num_answers=ANSWERS):
    """A VQA-RAD dataroot as load_vqa_entries reads it, its images (64-px
    grayscale PNGs) under ``root/images``; a third of the entries HEAD."""
    from PIL import Image

    os.makedirs(os.path.join(root, "cache"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(0)
    img2idx = {}
    for split, n, seed in (("train", n_train, 1), ("test", n_test, 2)):
        entries = jvqa.synthetic_vqa_entries(n, num_answers, seed=seed)
        samples, answers = [], []
        for i, e in enumerate(entries):
            name = f"{split}{i}.png"
            img2idx[name] = len(img2idx)
            Image.fromarray(rng.integers(0, 256, (IMG, IMG), np.uint8),
                            "L").save(os.path.join(root, "images", name))
            qid = 1000 * seed + i
            samples.append(dict(qid=qid, image_name=name,
                                question=e["question"],
                                answer_type=e["answer_type"],
                                image_organ="HEAD" if i % 3 == 2 else
                                "CHEST"))
            answers.append(dict(qid=qid, **e["answer"]))
        random.Random(seed).shuffle(answers)  # sorted by qid on load
        with open(os.path.join(root, f"{split}set.json"), "w") as f:
            json.dump(samples, f)
        with open(os.path.join(root, "cache", f"{split}_target.pkl"),
                  "wb") as f:
            pickle.dump(answers, f)
    with open(os.path.join(root, "imgid2idx.json"), "w") as f:
        json.dump(img2idx, f)
    return os.path.join(root, "images")


@pytest.mark.parametrize("workers", [1, 3])
def test_vqa_batches_match_jax(tmp_path, workers):
    """Entries read from a dataroot (organ filter chest, 2 of 8 train
    entries HEAD) and synthetic ones, through the s2s/bi mix."""
    image_root = _write_vqa_root(str(tmp_path))
    for organ in ("chest", "all"):
        assert tvqa.load_vqa_entries(str(tmp_path), "train", organ) == \
            jvqa.load_vqa_entries(str(tmp_path), "train", organ)
    jcfg, pcfg = _cfgs(task="vqa", s2s_prob=0.5, bi_prob=0.5)
    vocab = build_vocab(WORDS)
    kw = dict(split="train", image_root=image_root, seed=4)
    jl = jpre_data.BatchLoader(
        jvqa.VQADataset(jcfg, BertTokenizer(vocab), str(tmp_path), **kw),
        3, shuffle=True, seed=2, workers=workers, drop_last=False)
    tl = tpre_data.BatchLoader(
        tvqa.VQADataset(pcfg, TTokenizer(vocab), str(tmp_path), **kw),
        3, shuffle=True, seed=2, workers=workers, drop_last=False)
    assert len(tl.dataset) == 6
    _assert_same_batches(jl, tl)
    entries = jvqa.synthetic_vqa_entries(9, ANSWERS, seed=3)
    assert tvqa.synthetic_vqa_entries(9, ANSWERS, seed=3) == entries
    jl = jpre_data.BatchLoader(
        jvqa.VQADataset(jcfg, BertTokenizer(vocab), entries, seed=1,
                        image_loader=_image_loader), 3, seed=6)
    tl = tpre_data.BatchLoader(
        tvqa.VQADataset(pcfg, TTokenizer(vocab), entries, seed=1,
                        image_loader=_image_loader), 3, seed=6)
    _assert_same_batches(jl, tl, epochs=1)
    for q in ("Is the x ray normal? -yes/no", "What's seen, here...? -open"):
        assert tvqa.preprocess_question(q) == jvqa.preprocess_question(q)


def test_truncate_tokens_pair_matches_jax():
    """200 random pairs, caps and policies: the same lists, counts and the
    same draws from the rng (its next value agrees too); both raise where
    ``trunc_seg`` names an empty segment."""
    gen = random.Random(0)
    for case in range(200):
        a = list(range(gen.randint(0, 30)))
        b = list(range(100, 100 + gen.randint(0, 30)))
        kw = dict(max_len=gen.randint(5, 40), max_len_a=gen.choice([0, 8]),
                  max_len_b=gen.choice([0, 12]),
                  trunc_seg=gen.choice([None, "a", "b"]),
                  always_truncate_tail=gen.random() < 0.3)
        ja, jb, ta, tb = list(a), list(b), list(a), list(b)
        jr, tr = random.Random(case), random.Random(case)
        try:
            want = jsampling.truncate_tokens_pair(ja, jb, rng=jr, **kw)
        except IndexError:  # trunc_seg names a segment already empty
            with pytest.raises(IndexError):
                tsampling.truncate_tokens_pair(ta, tb, rng=tr, **kw)
            continue
        assert tsampling.truncate_tokens_pair(ta, tb, rng=tr, **kw) == want
        assert (ta, tb) == (ja, jb)
        assert tr.random() == jr.random()


def test_embedding_table_remaps_match_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(2, 8)).astype(np.float32)
    for rows in (2, 4, 6, 8):
        dst = rng.normal(size=(rows, 8)).astype(np.float32)
        np.testing.assert_array_equal(
            tckpt.expand_token_type_embeddings(src, dst),
            jckpt.expand_token_type_embeddings(src, dst))
    table = rng.normal(size=(10, 8)).astype(np.float32)
    for size in (4, 10, 17):  # shrink, keep, grow
        want = jckpt.resize_position_embeddings(
            {"position_embeddings": {"embedding": table}}, size)
        np.testing.assert_array_equal(
            tckpt.resize_position_embeddings(table, size),
            want["position_embeddings"]["embedding"])
    sd = {k: None for k in ("enc.encoder.layer.0.x", "mlm.predictions.bias",
                            "itm.linear.weight", "bert.pooler.dense.weight",
                            "cls.predictions.bias", "encoder.layer.1.y")}
    for mapping in ("pretrain_to_finetune", "finetune_to_decoder"):
        assert tckpt.torch_remap(sd, mapping) == jckpt.torch_remap(sd,
                                                                   mapping)


@pytest.fixture(scope="module")
def vlp_tree():
    """A tiny JAX VLP tree (report generation, relax_projection 0)."""
    return jax_vlp(finetune_config(), seed=3)[1]


def _pretrain_tree(vlp, rng):
    """The JAX CXRBERT pretrain tree of the same widths: the VLP encoder
    as ``enc`` with a 2-type token table, its MLM head as ``mlm``, an ITM
    head, all moved by noise so nothing equals the destination."""
    noisy = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(
            np.float32), vlp["params"])
    enc = dict(noisy["bert"])
    emb = enc["embeddings"] = dict(enc["embeddings"])
    H = emb["word_embeddings"]["embedding"].shape[1]
    emb["token_type_embeddings"] = {"embedding": rng.normal(
        size=(2, H)).astype(np.float32)}
    params = {"enc": enc, "mlm": noisy["cls"], "itm": {"linear": {
        "kernel": rng.normal(size=(H, 2)).astype(np.float32),
        "bias": np.zeros(2, np.float32)}}}
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.5,
                                   vlp["batch_stats"]["bert"])
    return params, {"enc": stats}


def _destination(vlp, task, relax, positions, rng):
    """The finetune tree a recover writes into: the VLP tree with its head
    for ``task`` (VQA: a new answer classifier, no MLM head), the MLM
    transform widened ``relax`` times, a position table of ``positions``
    rows."""
    params = dict(vlp["params"])
    bert = params["bert"] = dict(params["bert"])
    emb = bert["embeddings"] = dict(bert["embeddings"])
    H = emb["word_embeddings"]["embedding"].shape[1]
    emb["position_embeddings"] = {"embedding": rng.normal(
        size=(positions, H)).astype(np.float32)}
    if task == "vqa":
        del params["cls"]
        params["ans_classifier"] = {
            "fc1": {"kernel": rng.normal(size=(H, 2 * H)),
                    "bias": rng.normal(size=(2 * H,))},
            "fc2": {"kernel": rng.normal(size=(2 * H, ANSWERS)),
                    "bias": rng.normal(size=(ANSWERS,))}}
    elif relax:
        head = params["cls"] = dict(params["cls"])
        for name in ("transform_dense", "transform_LayerNorm"):
            head[name] = {k: rng.normal(size=np.shape(v)[:-1] + (
                relax * np.shape(v)[-1],)) for k, v in head[name].items()}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    return params, vlp["batch_stats"]


@pytest.mark.parametrize("task,relax,positions", [
    ("report_generation", 0, 40), ("report_generation", 4, 512),
    ("vqa", 0, 600)], ids=["shrink", "relax4", "vqa-grow"])
def test_recover_pretrain_matches_jax(tmp_path, vlp_tree, task, relax,
                                      positions):
    """A JAX CXRBERT tree -> cxrbert_state_dict_from_flax -> a file ->
    recover_pretrain_into_vlp equals the JAX recover path
    (_torch_pretrain_to_vlp_sd + init_vlp_from_torch, exported by
    vlp_state_dict_from_flax), every tensor bit for bit: the 512-row
    position table cut or grown, token types 2 -> 6 (rows 2, 3, 4 = pretrain
    row 0, row 5 = row 1), the MLM transform tiled, the trunk's running
    statistics, ITM dropped; the VQA classifier is missing from the file
    and keeps its values."""
    rng = np.random.default_rng(positions)
    pre_params, pre_stats = _pretrain_tree(vlp_tree, rng)
    path = str(tmp_path / "model.0.bin")
    save_state_dict(cxrbert_state_dict_from_flax(pre_params, pre_stats),
                    path)
    dst_params, dst_stats = _destination(vlp_tree, task, relax, positions,
                                         rng)
    sd = _torch_pretrain_to_vlp_sd(torch_init.load_torch_state_dict(path),
                                   relax or 1)
    params, stats = torch_init.init_vlp_from_torch(dst_params, dst_stats, sd)
    want = vlp_state_dict_from_flax(params, stats)

    _, pcfg = _cfgs(task=task)
    pcfg = dataclasses.replace(pcfg, bert=dataclasses.replace(
        pcfg.bert, relax_projection=relax,
        max_position_embeddings=positions))
    model = tft.build_model(pcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           vlp_state_dict_from_flax(dst_params,
                                                    dst_stats).items()})
    loaded, missing = tckpt.recover_pretrain_into_vlp(model, path)
    assert missing == (["ans_classifier.0.bias", "ans_classifier.0.weight",
                        "ans_classifier.2.bias", "ans_classifier.2.weight"]
                       if task == "vqa" else [])
    got = model.state_dict()
    assert set(loaded) | set(missing) == set(got)
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    types = got["txt_embeddings.token_type_embeddings.weight"].numpy()
    pre_types = pre_params["enc"]["embeddings"]["token_type_embeddings"][
        "embedding"]
    np.testing.assert_array_equal(types[[0, 1, 2, 3, 4, 5]],
                                  pre_types[[0, 1, 0, 0, 0, 1]])


def test_recover_refuses_other_files(tmp_path):
    model = tft.build_model(_cfgs()[1])
    with pytest.raises(ValueError, match="is a directory"):
        tckpt.recover_pretrain_into_vlp(model, str(tmp_path))
    path = str(tmp_path / "finetune.bin")
    torch.save(model.state_dict(), path)  # the VLP layout, no enc.*
    with pytest.raises(ValueError, match="not a CXRBERT pretrain"):
        tckpt.recover_pretrain_into_vlp(model, path)


def _write_reports(d, n=8):
    from PIL import Image

    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS) + "\n")
    rng = np.random.default_rng(0)
    recs = tpre_data.synthetic_records(n, random.Random(1), words=WORDS)
    for r in recs:
        Image.fromarray(rng.integers(0, 256, (IMG, IMG), np.uint8),
                        "L").save(os.path.join(d, r["img"]), format="PNG")
    data = os.path.join(d, "train.jsonl")
    with open(data, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return data, vocab


TINY = ["--bert_model", "test-tiny", "--vocab_size", str(VOCAB),
        "--img_size", str(IMG), "--len_vis_input", str(VIS),
        "--max_seq_length", "24", "--max_len_b", "17", "--max_pred", "3",
        "--train_batch_size", "2", "--learning_rate", "1e-3",
        "--device", "cpu"]


def test_finetune_cli_report_generation_on_cpu(tmp_path):
    """The port's pretrain CLI writes model.0.bin; the finetune CLI
    recovers it (fused_ln on through --config_path: the plain version on
    the CPU), runs 2 epochs of 4 micro-steps at accumulation 2, writes
    model.0.bin and model.1.bin in the reference VLP layout (they load
    strictly) with opt.json and metrics.jsonl; serve_main serves model.1.bin
    in-process."""
    data, vocab = _write_reports(str(tmp_path))
    pre = str(tmp_path / "pretrain")
    pretrain_main.main(["--train_dataset", data, "--vocab_file", vocab,
                        "--output_path", pre, "--bert_model", "test-tiny",
                        "--vocab_size", str(VOCAB), "--img_size", str(IMG),
                        "--num_image_embeds", "3", "--seq_len", "12",
                        "--batch_size", "4", "--epochs", "1",
                        "--device", "cpu"])
    (tmp_path / "cfg.json").write_text(json.dumps({"fused_ln": True}))
    out = str(tmp_path / "finetune")
    argv = ["--src_file", data, "--vocab_file", vocab, "--output_dir", out,
            "--model_recover_path", os.path.join(pre, "model.0.bin"),
            "--config_path", str(tmp_path / "cfg.json"),
            "--num_train_epochs", "2", "--gradient_accumulation_steps", "2",
            *TINY]
    result = finetune_main.main(argv)
    rows = result["epochs"]
    assert [r["epoch"] for r in rows] == [0, 1] and result["vqa_eval"] is None
    assert all(r["micro_steps"] == 4 and np.isfinite(r["loss"])
               and r["examples_per_s"] > 0 for r in rows)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    with open(os.path.join(out, "opt.json")) as f:
        assert json.load(f)["model_recover_path"].endswith("model.0.bin")
    cfg = finetune_main.config_from_args(
        finetune_main.build_parser().parse_args(argv))
    assert cfg.bert.fused_ln and cfg.bert.type_vocab_size == 6
    model = VLPForPreTraining(cfg.bert, cfg.image, len_vis_input=VIS)
    for epoch in (0, 1):
        assert load_vlp_checkpoint(
            model, os.path.join(out, f"model.{epoch}.bin")) == []
    args = serve_main.build_parser().parse_args([
        "--vocab_file", vocab, "--model_recover_path",
        os.path.join(out, "model.1.bin"), "--device", "cpu",
        "--bert_model", "test-tiny", "--vocab_size", str(VOCAB),
        "--len_vis_input", str(VIS), "--img_size", str(IMG),
        "--max_txt_length", "4", "--batch_size", "2"])
    run, _, _ = serve_main.build_engine(args, logging.getLogger("t"))
    ids = run(np.random.default_rng(1).integers(0, 256, (2, IMG, IMG, 3),
                                                dtype=np.uint8))
    assert np.asarray(ids).shape == (2, 4)
    # trained by this port: decoded in its train forward's position layout
    assert window_positions("auto", os.path.join(out, "model.1.bin")) == \
        "train"
    assert finetune_main.build_parser().parse_args(argv[:-2]).device == \
        "cuda"


def test_finetune_cli_vqa_on_cpu(tmp_path):
    """VQA from a dataroot (organ filter all): 2 epochs of 4 micro-steps
    from random init, then the eval on the test split; the checkpoint holds
    the 458-way answer classifier and no MLM head."""
    _, vocab = _write_reports(str(tmp_path), n=1)
    image_root = _write_vqa_root(str(tmp_path / "vqa"), num_answers=458)
    out = str(tmp_path / "finetune")
    result = finetune_main.main([
        "--tasks", "vqa", "--vqa_eval", "true", "--vqa_rad", "all",
        "--src_file", str(tmp_path / "vqa"), "--image_root", image_root,
        "--vocab_file", vocab, "--output_dir", out, "--num_train_epochs",
        "2", "--s2s_prob", "0.5", "--bi_prob", "0.5", *TINY])
    assert all(r["micro_steps"] == 4 and np.isfinite(r["vqa_loss"])
               and 0 <= r["train_acc"] <= 1 for r in result["epochs"])
    ev = result["vqa_eval"]
    assert 0 <= ev["vqa_acc"] <= 1 and ev["n_closed"] + ev["n_open"] == 6
    sd = torch.load(os.path.join(out, "model.1.bin"))
    assert sd["ans_classifier.2.weight"].shape == (458, 64)
    assert not any(k.startswith("cls.") for k in sd)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert "vqa_eval" in [json.loads(line) for line in f][-1]
