"""The port's pretraining host side and entry point: the mask module against
the JAX package's golden builders, the dataset and loader against the JAX
package's batches (bit for bit, from the same records and seed), the
training dropout, the train step's use of its generator, and the pretrain
CLI end to end on the CPU with a 2-layer model."""
import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.cli import pretrain_main
from medvill_torch.convert import load_cxrbert_checkpoint
from medvill_torch.data import masks as tmasks
from medvill_torch.data import pretrain as tdata
from medvill_torch.data.tokenization import BertTokenizer as TTokenizer
from medvill_torch.models import bert as tbert
from medvill_torch.ops.dropout import DropoutRNG, dropout
from medvill_torch.train import pretrain as tpre
from medvill_tpu.core.config import (BertConfig, ImageEncoderConfig,
                                     MaskVariant, PretrainConfig)
from medvill_tpu.data import masks as jmasks
from medvill_tpu.data import pretrain as jdata
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab

WORDS = [f"word{i}" for i in range(50)]


@pytest.mark.parametrize("extra_cls", [False, True], ids=["plain", "extra"])
def test_dense_masks_match_reference_builders(extra_cls):
    geom = tmasks.MaskGeometry(num_image_embeds=4, seq_len=9,
                               extra_text_cls=extra_cls)
    jgeom = jmasks.MaskGeometry(4, 9, extra_text_cls=extra_cls)
    specs = [(v, t) for v in MaskVariant for t in (1, 5, 10)]
    spec = torch.tensor(specs, dtype=torch.int32)
    got = tmasks.dense_mask_from_spec(spec, geom).numpy()
    for (v, t), g in zip(specs, got):
        np.testing.assert_array_equal(
            g, jmasks.reference_dense_mask(v, t, jgeom))
        np.testing.assert_array_equal(
            g, tmasks.reference_dense_mask(v, t, geom))
    bias = tmasks.bias_from_spec(spec, geom)
    assert bias.shape == (len(specs), 1, geom.total_len, geom.total_len)
    np.testing.assert_array_equal(bias[:, 0].numpy(),
                                  (1.0 - got) * -10000.0)


def test_seq2seq_masks_match_reference_builder():
    vis, L = 4, 16
    for mode, vid in tmasks.SEQ2SEQ_VARIANT_IDS.items():
        for n in (vis + 3, vis + 7, L):
            got = tmasks.seq2seq_spec_dense(torch.tensor([vid]),
                                            torch.tensor([n]), vis, L)[0]
            np.testing.assert_array_equal(
                got.numpy(), jmasks.seq2seq_dense_mask(mode, n, vis, L))


def _cfgs(**kw):
    image = ImageEncoderConfig(img_size=64, num_image_embeds=3)
    jcfg = PretrainConfig(seq_len=12, bert=BertConfig.test_tiny(64),
                          image=image, batch_size=4, **kw)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(jcfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(image))
    return jcfg, tcfg.PretrainConfig(**d)


def _image_loader(path):
    """A deterministic image per path, the same for both loaders."""
    seed = int(path[3:-4])
    return np.random.default_rng(seed).integers(0, 256, (64, 64, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("flags", [dict(), dict(bar_attn=False, mixed=True,
                                                bi_prob=0.4),
                                   dict(bar_attn=False, disturbing_mask=True)],
                         ids=["bar", "mixed", "noncross"])
def test_batches_match_jax_loader(workers, flags):
    jcfg, tcfg_ = _cfgs(**flags)
    vocab = build_vocab(WORDS)
    recs = jdata.synthetic_records(18, random.Random(3), words=WORDS)
    jl = jdata.BatchLoader(
        jdata.CXRPretrainDataset(recs, BertTokenizer(vocab), jcfg, seed=5,
                                 image_loader=_image_loader),
        4, shuffle=True, seed=7, workers=workers)
    tl = tdata.BatchLoader(
        tdata.CXRPretrainDataset(recs, TTokenizer(vocab), tcfg_, seed=5,
                                 image_loader=_image_loader),
        4, shuffle=True, seed=7, workers=workers)
    assert len(tl) == len(jl) == 4
    try:
        for _ in range(2):  # two epochs: the shuffle and the RNGs move on
            jb, tb = list(jl), list(tl)
            assert len(jb) == len(tb) == 4
            for a, b in zip(jb, tb):
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        tl.close()
    assert tdata.synthetic_records(5) == jdata.synthetic_records(5)


def test_dropout_draws_from_its_generator():
    x = torch.ones(64, 128)
    a = dropout(x, 0.1, DropoutRNG(3, "cpu"))
    b = dropout(x, 0.1, DropoutRNG(3, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, 0.1, DropoutRNG(4, "cpu")))
    assert abs((a == 0).float().mean().item() - 0.1) < 0.01
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    rng = DropoutRNG(3, "cpu")
    assert rng.next_seed() != rng.next_seed()


@pytest.mark.parametrize("fused_ln", [False, True], ids=["ln", "fused-ln"])
def test_bert_layer_training_dropout(fused_ln):
    """deterministic=True needs no rng and ignores the rates; False draws
    from the rng (the same seed repeats), and with rates 0 it equals the
    deterministic output; gradients flow through the fused LN."""
    cfg = dataclasses.replace(tcfg.BertConfig.test_tiny(), fused_ln=fused_ln)
    torch.manual_seed(0)
    layer = tbert.BertLayer(cfg)
    x = torch.randn(2, 5, cfg.hidden_size, requires_grad=True)
    det, _ = layer(x, None)
    a, _ = layer(x, None, deterministic=False, rng=DropoutRNG(1, "cpu"))
    b, _ = layer(x, None, deterministic=False, rng=DropoutRNG(1, "cpu"))
    assert torch.equal(a, b) and not torch.allclose(a, det)
    with pytest.raises(ValueError):
        layer(x, None, deterministic=False)
    zero = tbert.BertLayer(dataclasses.replace(
        cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    zero.load_state_dict(layer.state_dict())
    z, _ = zero(x, None, deterministic=False, rng=DropoutRNG(1, "cpu"))
    torch.testing.assert_close(z, det)
    a.sum().backward()
    assert all(p.grad is not None for p in layer.parameters())


def _tiny_state(**kw):
    _, cfg = _cfgs(**kw)
    cfg = dataclasses.replace(cfg, lr=1e-3, gradient_accumulation_steps=1)
    recs = tdata.synthetic_records(4, random.Random(0), words=WORDS)
    ds = tdata.CXRPretrainDataset(recs, TTokenizer(build_vocab(WORDS)), cfg,
                                  seed=0, image_loader=_image_loader)
    batch = tpre.to_device(next(iter(tdata.BatchLoader(ds, 4))), "cpu")
    return cfg, batch


def test_train_step_draws_from_its_generator_and_learns():
    """Same generator seed, same pixel indices and dropout: the same
    losses; a repeated batch's loss falls (dropout on)."""
    cfg, batch = _tiny_state()
    runs = []
    for _ in range(2):
        state = tpre.init_state(cfg, seed=1, device="cpu")
        step = tpre.make_train_step(cfg)
        gen = torch.Generator().manual_seed(9)
        runs.append([step(state, batch, gen)["loss"].item()
                     for _ in range(6)])
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all() and runs[0][-1] < runs[0][0]
    assert state.step == 6
    gen = torch.Generator().manual_seed(9)
    pix = tpre.sample_pixel_indices(gen, 4, 3)
    assert pix.tolist() == sorted(set(pix.tolist())) and len(pix) == 3


def test_gathered_mlm_loss_equals_full_projection():
    """A bound above the label count changes nothing: the gathered and the
    all-positions CE agree (mlm_gather_bound 0 projects every position)."""
    cfg, batch = _tiny_state()
    cfg = dataclasses.replace(cfg, itm_task=False)
    state = tpre.init_state(cfg, seed=2, device="cpu")
    out = {}
    for bound in (0, 6):
        c = dataclasses.replace(cfg, mlm_gather_bound=bound)
        with torch.no_grad():
            _, m = tpre.pretrain_loss_and_metrics(
                state.model, batch, None, torch.tensor([0, 1, 3]), c,
                train=False)
        out[bound] = m
    assert (batch["txt_labels"] != -100).sum(1).max() <= 6
    for k in ("mlm_loss", "mlm_correct", "mlm_total"):
        torch.testing.assert_close(out[0][k], out[6][k])


def _write_dataset(d, n=6, size=64):
    from PIL import Image

    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS) + "\n")
    rng = np.random.default_rng(0)
    recs = tdata.synthetic_records(n, random.Random(1), words=WORDS)
    for r in recs:
        Image.fromarray(rng.integers(0, 256, (size, size), np.uint8),
                        "L").save(os.path.join(d, r["img"]), format="PNG")
    data = os.path.join(d, "train.jsonl")
    with open(data, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return data, vocab


def test_pretrain_cli_end_to_end_on_cpu(tmp_path):
    """2 epochs of 3 micro-batches, accumulation 2, a 2-layer model at
    64 px: finite losses, one checkpoint per epoch in the CXRBERT layout
    that loads strictly, metrics.jsonl rows."""
    data, vocab = _write_dataset(str(tmp_path))
    out = str(tmp_path / "run")
    argv = ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", out, "--bert_model", "test-tiny",
            "--vocab_size", "64", "--img_size", "64", "--num_image_embeds",
            "3", "--seq_len", "12", "--batch_size", "2", "--epochs", "2",
            "--gradient_accumulation_steps", "2", "--num_workers", "2",
            "--lr", "1e-3", "--device", "cpu", "--log_freq", "1"]
    rows = pretrain_main.main(argv)
    assert len(rows) == 2 and all(r["micro_steps"] == 3 for r in rows)
    assert all(np.isfinite(r["avg_loss"]) and r["pairs_per_s"] > 0
               for r in rows)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    cfg = pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv))
    model = tpre.build_model(cfg)
    for epoch in (0, 1):
        assert load_cxrbert_checkpoint(
            model, os.path.join(out, f"model.{epoch}.bin")) == []
    assert "enc.encoder.layer.1.output.LayerNorm.weight" in \
        model.state_dict()
    with pytest.raises(SystemExit):  # not ported: the mesh flags
        pretrain_main.build_parser().parse_args(argv + ["--model_parallel",
                                                        "2"])
    args = pretrain_main.build_parser().parse_args(argv[:-4])
    assert args.device == "cuda"


TRUNK_WARNING = "randomly initialized"


@pytest.mark.parametrize("weight_load", [False, True],
                         ids=["random-trunk", "restored"])
def test_pretrain_cli_warns_of_a_random_trunk_only_without_a_restore(
        tmp_path, caplog, weight_load):
    """The frozen trunk is reported random unless --weight_load restored it
    from --pre_trained_model_path (medvill_tpu/cli/pretrain_main.py:
    233-243)."""
    data, vocab = _write_dataset(str(tmp_path), n=2)
    argv = ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", str(tmp_path / "run"), "--bert_model",
            "test-tiny", "--vocab_size", "64", "--img_size", "64",
            "--num_image_embeds", "3", "--seq_len", "12", "--batch_size",
            "2", "--epochs", "1", "--device", "cpu"]
    if weight_load:
        cfg = pretrain_main.config_from_args(
            pretrain_main.build_parser().parse_args(argv))
        ckpt = str(tmp_path / "pretrained.bin")
        torch.save(tpre.build_model(cfg).state_dict(), ckpt)
        argv += ["--weight_load", "true", "--pre_trained_model_path", ckpt]
    with caplog.at_level("INFO", logger="medvill_torch"):
        rows = pretrain_main.main(argv)
    assert len(rows) == 1 and np.isfinite(rows[0]["avg_loss"])
    assert ("restored" in caplog.text) == weight_load
    assert (TRUNK_WARNING in caplog.text) != weight_load
