"""The port's finetune step against the JAX package's on the same numpy
inputs and the same weights (carried through vlp_state_dict_from_flax):
the training forward's gathered MLM logits and the VQA logits (training
and inference), the losses (label smoothing 0.1 and 0, drop-worst 0 and
0.5, the VQA BCE), every gradient and the BatchNorm statistics of the
train-mode trunk, with the attention kernel (the JAX side runs its Pallas
kernel in interpret mode) and on the dense bias; relax_projection 4 with
mixed task_idx over the s2s, bi and bar modes; and the parameters and
BatchNorm statistics after three BertAdam updates at accumulation 1 and 2
against make_train_step + make_finetune_tx.  Dropout is 0: the two
packages draw different dropout bits."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import vlp_state_dict_from_flax
from medvill_torch.train import finetune as tft
from medvill_torch.train import losses as tlosses
from medvill_tpu.data.pretrain import collate
from medvill_tpu.data.seq2seq import Seq2seqPreprocessor
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.data.vqa import VQADataset, synthetic_vqa_entries
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.ops.flash_attention import (FAMILY_SEQ2SEQ,
                                             make_attention_fn)
from medvill_tpu.train import finetune as jft
from medvill_tpu.train import losses as jlosses
from medvill_tpu.train import optim as joptim
from medvill_tpu.train.pretrain import TrainState
from tests.torch_port_support import (IMG, VOCAB, finetune_config, perturb,
                                      random_batch_stats)
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

ANSWERS = 7
MODES = ("s2s", "s2s", "bi", "bar")  # one batch row each
WORDS = [f"word{i}" for i in range(VOCAB - 5)]


def jax_cfg(task="report_generation", flash=True, relax=0, **kw):
    cfg = finetune_config(relax_projection=relax)
    bert = dataclasses.replace(cfg.bert, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    # text fits the 24-position window: 4 image embeds + 3 specials + 17
    return dataclasses.replace(cfg, bert=bert, task=task, max_len_b=17,
                               use_flash_attention=flash,
                               vqa_num_answers=ANSWERS, **kw)


def port_cfg(cfg) -> tcfg.FinetuneConfig:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name != "mesh_shape"}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(cfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(cfg.image))
    return tcfg.FinetuneConfig(**d)


@pytest.fixture(scope="module")
def base():
    """Weights and BN statistics of the report-generation model (one JAX
    init for the module), perturbed as test_torch_port_pretrain.py's: every
    path matters, and the train-mode trunk's rounding is not blown up by
    large downstream weights."""
    cfg = jax_cfg()
    L = cfg.max_seq_length
    model = jft.build_model(cfg)
    init = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, L), jnp.int32), jnp.zeros((2, L), jnp.int32),
        jnp.zeros((2, 1, L, L)),
        masked_pos=jnp.zeros((2, cfg.max_pred), jnp.int32)))(
            jax.random.PRNGKey(5))
    rng = np.random.default_rng(5)
    params = perturb(init["params"], rng, 0.05)
    params["bert"]["img_encoder"] = perturb(
        init["params"]["bert"]["img_encoder"], rng, 0.02)
    return {"params": params,
            "batch_stats": random_batch_stats(init["batch_stats"], rng)}


def variables(base, task="report_generation", relax=0):
    """``base`` for ``task``: VQA swaps the MLM head (which the JAX VQA
    model never builds) for a random answer classifier; relax_projection
    tiles the head's transform with noise per task slice."""
    rng = np.random.default_rng(7)
    params = dict(base["params"])
    H = params["bert"]["img_projection"]["kernel"].shape[1]
    if task == "vqa":
        del params["cls"]
        params["ans_classifier"] = {
            "fc1": {"kernel": rng.normal(0, 0.3, (H, 2 * H)),
                    "bias": rng.normal(0, 0.1, (2 * H,))},
            "fc2": {"kernel": rng.normal(0, 0.3, (2 * H, ANSWERS)),
                    "bias": rng.normal(0, 0.1, (ANSWERS,))}}
    elif relax:
        head = params["cls"] = dict(params["cls"])
        for name in ("transform_dense", "transform_LayerNorm"):
            head[name] = {k: np.tile(v, (1,) * (v.ndim - 1) + (relax,))
                          + rng.normal(0, 0.1, v.shape[:-1]
                                       + (relax * v.shape[-1],))
                          for k, v in head[name].items()}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    params)
    return {"params": params, "batch_stats": base["batch_stats"]}


def make_batches(cfg, n, seed=0):
    """``n`` numpy batches of 4 rows, row i through mode MODES[i]."""
    tok = BertTokenizer(build_vocab(WORDS))
    rng = random.Random(seed)
    img_rng = np.random.default_rng(seed)
    out = []
    if cfg.task == "vqa":
        entries = synthetic_vqa_entries(4 * n, ANSWERS, seed=seed)
    for b in range(n):
        rows = []
        for i, mode in enumerate(MODES):
            procs = {"s2s": Seq2seqPreprocessor(cfg, tok, "s2s"),
                     "bi": Seq2seqPreprocessor(cfg, tok, "bi"),
                     "bar": Seq2seqPreprocessor(cfg, tok, "s2s", bar=True)}
            if cfg.task == "vqa":
                ds = VQADataset(cfg, tok, [entries[4 * b + i]],
                                image_loader=lambda _: None)
                row = ds.fetch(0, rng=rng)
                row.update(procs[mode](tok.tokenize(
                    entries[4 * b + i]["question"].split("?")[0]), rng=rng))
            else:
                row = procs[mode](rng.choices(WORDS, k=rng.randint(3, 20)),
                                  rng=rng)
            row["image"] = img_rng.integers(0, 256, (IMG, IMG, 3),
                                            dtype=np.uint8)
            rows.append(row)
        out.append(collate(rows))
    return out


def jax_attention_fn(cfg, batch):
    if not cfg.use_flash_attention:
        return None
    return make_attention_fn(jnp.asarray(batch["mask_spec"]),
                             cfg.len_vis_input + 2, family=FAMILY_SEQ2SEQ)


def jax_loss(model, cfg, stats, batch, ratio):
    """make_train_step's loss_fn (medvill_tpu/train/finetune.py:79-120)
    with the logits and VQA inference logits as well."""
    attention_fn = jax_attention_fn(cfg, batch)
    bias = (None if attention_fn is not None else
            jft.finetune_bias(jnp.asarray(batch["mask_spec"]),
                              cfg.len_vis_input, cfg.max_seq_length))
    args = [jnp.asarray(batch[k]) for k in ("image", "input_ids",
                                            "segment_ids")] + [bias]

    def loss_fn(params):
        params = joptim.stop_frozen(params, jresnet.cnn_freeze_mask(
            params, ("bert", "img_encoder")))
        v = {"params": params, "batch_stats": stats}
        kw = dict(deterministic=False, train_cnn=True,
                  attention_fn=attention_fn, mutable=["batch_stats"])
        if cfg.task == "vqa":
            logits, upd = model.apply(v, *args, **kw)
            loss = jlosses.bce_with_logits(logits,
                                           jnp.asarray(batch["ans_target"]))
            infer = model.apply(v, *args, deterministic=True,
                                attention_fn=attention_fn, vqa_inference=True)
        else:
            logits, upd = model.apply(
                v, *args, masked_pos=jnp.asarray(batch["masked_pos"]),
                task_idx=jnp.asarray(batch["task_idx"]), **kw)
            labels = jnp.asarray(batch["masked_ids"])
            per_pos = (jlosses.label_smoothing_loss(
                logits, labels, cfg.label_smoothing, cfg.bert.vocab_size)
                if cfg.label_smoothing > 0 else
                jlosses.cross_entropy_per_example(logits, labels))
            loss = jlosses.drop_worst_normalize(
                per_pos, jnp.asarray(batch["masked_weights"]), ratio)
            infer = logits
        return loss, (logits, infer, upd["batch_stats"])

    return loss_fn


def torch_model(cfg, v):
    pc = port_cfg(cfg)
    model = tft.build_model(pc)
    sd = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in sd.items()})
    return model, pc


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}


CASES = {
    # (task, flash, relax, label_smoothing, drop-worst ratio)
    "reportgen-kernel-ls0.1": ("report_generation", True, 0, 0.1, 0.0),
    "reportgen-dense-ls0-drop0.5": ("report_generation", False, 0, 0.0, 0.5),
    "reportgen-relax4-kernel": ("report_generation", True, 4, 0.1, 0.5),
    "vqa-kernel": ("vqa", True, 0, 0.1, 0.0),
    "vqa-dense": ("vqa", False, 0, 0.1, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_gradients_match_jax(base, case):
    """One training forward and backward (train-mode BatchNorm, rows in the
    s2s, s2s, bi and bar modes; relax_projection 4 selects by task_idx 3,
    3, 0, 3): the logits (VQA also at inference, h[:, 0] * h[:, vis + 1])
    within 1e-4 of their scale, the loss 1e-5, every trainable gradient
    within 1e-3 of the largest entry of its tensor (floor 1e-6), the BN
    statistics 1e-3 -- the tolerances of test_torch_port_pretrain.py, for
    the same reason: the train-mode trunk's features are 2e-3 of scale apart
    between the packages at this batch size."""
    task, flash, relax, ls, ratio = CASES[case]
    cfg = jax_cfg(task, flash, relax, label_smoothing=ls)
    v = variables(base, task, relax)
    batch = make_batches(cfg, 1, seed=3)[0]
    assert batch["mask_spec"][:, 0].tolist() == [1, 1, 0, 2]
    model = jft.build_model(cfg)
    (want_loss, (want_logits, want_infer, want_stats)), want_g = jax.jit(
        jax.value_and_grad(jax_loss(model, cfg, v["batch_stats"], batch,
                                    ratio), has_aux=True))(v["params"])

    tm, pc = torch_model(cfg, v)
    tb = torch_batch(batch)
    attn = (tft.make_attention_fn(tb["mask_spec"], cfg.len_vis_input + 2,
                                  family=tft.FAMILY_SEQ2SEQ) if flash else
            None)
    bias = None if flash else tft.finetune_bias(
        tb["mask_spec"], cfg.len_vis_input, cfg.max_seq_length)
    args = (tb["image"], tb["input_ids"], tb["segment_ids"], bias)
    with torch.no_grad():
        if task == "vqa":  # running statistics, before the train forward
            infer = tm(*args, attention_fn=attn, vqa_inference=True)
            np.testing.assert_allclose(
                infer.numpy(), np.asarray(want_infer), rtol=0,
                atol=1e-4 * np.abs(np.asarray(want_infer)).max())
        stats = {k: b.clone() for k, b in tm.named_buffers()}
        logits = tm(*args, deterministic=False, train_cnn=True,
                    attention_fn=attn, masked_pos=tb["masked_pos"],
                    task_idx=tb["task_idx"])
        for k, b in tm.named_buffers():
            b.copy_(stats[k])
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(want_logits), rtol=0,
        atol=1e-4 * np.abs(np.asarray(want_logits)).max())
    loss, metrics = tft.finetune_loss_and_metrics(tm, tb, None, pc, ratio)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    assert set(metrics) == ({"vqa_loss", "batch_score", "n", "loss"}
                            if task == "vqa" else {"masked_lm_loss", "loss"})
    grads = vlp_state_dict_from_flax(want_g, v["batch_stats"])
    n = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
            continue
        w = grads[name]
        if name.startswith("pooler."):  # no loss reads the pooled output
            assert p.grad is None and not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)
        n += 1
    # 2 layers x 16, embeddings 5, projection 2; MLM head 5 or VQA head 4
    assert n == 2 * 16 + 7 + (4 if task == "vqa" else 5)
    new_stats = vlp_state_dict_from_flax(v["params"], want_stats)
    for k, t in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new_stats[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)


@pytest.mark.parametrize("smoothing", [0.1, 0.0])
@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_losses_match_jax(smoothing, ratio):
    """The loss functions alone on random logits over a 30522-token
    vocabulary, labels with ignore-index 0 padding and zero weights: value
    and gradient within 1e-5 relative."""
    rng = np.random.default_rng(int(smoothing * 10 + ratio * 100))
    V = 30522
    logits = rng.normal(0, 3, (4, 6, V)).astype(np.float32)
    labels = rng.integers(1, V, (4, 6)).astype(np.int32)
    labels[:, 4:] = 0
    weights = (labels != 0).astype(np.float32)

    def jax_fn(x):
        per = (jlosses.label_smoothing_loss(x, labels, smoothing, V)
               if smoothing else
               jlosses.cross_entropy_per_example(x, labels))
        return jlosses.drop_worst_normalize(per, weights, ratio)

    want, want_g = jax.value_and_grad(jax_fn)(logits)
    x = torch.from_numpy(logits).requires_grad_()
    lab = torch.from_numpy(labels)
    per = (tlosses.label_smoothing_loss(x, lab, smoothing, V) if smoothing
           else tlosses.cross_entropy_per_example(x, lab))
    got = tlosses.drop_worst_normalize(per, torch.from_numpy(weights), ratio)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want_g)).max())
    t = rng.uniform(0, 1, (4, ANSWERS)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.bce_with_logits(torch.from_numpy(logits[:, 0, :ANSWERS]),
                                torch.from_numpy(t)).item(),
        float(jlosses.bce_with_logits(logits[:, 0, :ANSWERS], t)), rtol=1e-6)


@pytest.mark.parametrize("task,accum", [("report_generation", 1),
                                        ("vqa", 2)])
def test_three_bertadam_updates_match_jax(base, task, accum):
    """The JAX CLI's optimizer (masked whole-trunk freeze around
    make_finetune_tx, lr applied in make_train_step) against the port's
    BertAdam: 3 updates (3 * accum micro-steps, each on its own batch),
    lr 1e-3, t_total 4, warmup 0.1, so the lr scales are 0, 0.833, 0.556.
    Every parameter within 5e-4 (one update moves an entry by up to ~3e-3),
    BN statistics 1e-3, as test_torch_port_pretrain.py; every trainable
    tensor moved but the pooler's bias (no gradient, no decay), the frozen
    trunk not."""
    cfg = jax_cfg(task, flash=False, lr=1e-3,
                  gradient_accumulation_steps=accum)
    v = variables(base, task)
    model = jft.build_model(cfg)
    tx = joptim.masked_trainable(
        jft.make_finetune_tx(cfg), lambda p: jresnet.cnn_freeze_mask(
            p, ("bert", "img_encoder")))
    state = TrainState(step=jnp.zeros([], jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    step = jax.jit(jft.make_train_step(model, tx, cfg, t_total=4))
    data = make_batches(cfg, 3 * accum, seed=4)
    for b in data:
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))

    tm, pc = torch_model(cfg, v)
    ts = tft.init_state(pc, t_total=4, device="cpu")
    ts.model.load_state_dict(tm.state_dict())
    train_step = tft.make_train_step(pc)
    gen = torch.Generator().manual_seed(0)
    for b in data:
        train_step(ts, torch_batch(b), gen)
    assert ts.step == 3 * accum and ts.tx.optimizer.opt_step == 3
    want = vlp_state_dict_from_flax(state.params, state.batch_stats)
    before = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    moved = 0
    for k, t in ts.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)
            continue
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=5e-4,
                                   err_msg=k)
        moved += not np.array_equal(t.numpy(), before[k])
    # 2 layers x 16, embeddings 5, projection 2, the pooler's weight (by
    # weight decay alone; its bias stays), MLM head 5 (+ the tied decoder
    # listed again) or VQA head 4
    assert moved == 2 * 16 + 8 + (4 if task == "vqa" else 6)


def test_bertadam_schedules_and_decay_groups(base):
    """The three schedules at the JAX functions' points (1e-6); the decayed
    parameters are the ones JAX's no_decay_mask decays, name for name: the
    word embedding (handed over once, though the MLM decoder shares it) and
    the MLM head's vocabulary bias (flax ``decoder_bias``) among them, no
    LayerNorm parameter and no Linear bias."""
    for name, fn in joptim.SCHEDULES.items():
        for x in (0.0, 0.05, 0.1, 0.5, 1.0, 1.5):
            np.testing.assert_allclose(
                tft.optim.SCHEDULES[name](x, 0.1), float(fn(x, 0.1)),
                rtol=1e-6, atol=1e-7)
    v = variables(base)
    mask = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32),
        joptim.no_decay_mask(v["params"]), v["params"])
    want = {k for k, a in vlp_state_dict_from_flax(
        mask, v["batch_stats"]).items()
        if a.all() and not k.startswith("img_encoder.")}
    model = tft.build_model(port_cfg(jax_cfg()))
    decay, exempt = tft.optim.decay_groups(model, 0.01)
    names = {id(p): n for n, p in model.named_parameters()}
    got = {names[id(p)] for p in decay["params"]}
    assert got == want - {"cls.predictions.decoder.weight"}
    assert {"txt_embeddings.word_embeddings.weight",
            "cls.predictions.bias"} <= got
    assert decay["weight_decay"] == 0.01 and exempt["weight_decay"] == 0.0
    assert len(decay["params"]) + len(exempt["params"]) == len(
        tft.optim.trainable(model))
