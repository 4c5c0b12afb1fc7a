"""The port's retrieval slice against the JAX package's on the same numpy
inputs and weights (carried through cxrbert_state_dict_from_flax and
cnn_bert_state_dict_from_flax): the datasets' train pairs and eval rows bit
for bit in both branches (the 300-try fallback and the refusals
included), CXRBERT's ``itm_forward``, one training step's loss, accuracy,
gradients and trunk statistics and three AdamW steps, the score step and
``run_retrieval_eval`` (metrics and rank dumps), the CNN_BERT baseline in
float64 (forward, gradients with the trunk trained, three AdamW steps), and
the ``torch_init`` remaps (reference, torchvision and HF layouts) and
``restore_pretrained``.  Dropout is 0: the two packages draw different
dropout bits.  ``num_image_embeds`` is the trunk's 4 fibers at 64 px, so
both packages' sorted random-pixel draws are the identity."""
import dataclasses
import json
import os
import random
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch import torch_init as tinit
from medvill_torch.checkpoint import restore_pretrained
from medvill_torch.convert import (cnn_bert_state_dict_from_flax,
                                   cxrbert_state_dict_from_flax,
                                   load_cnn_bert_checkpoint,
                                   load_cxrbert_checkpoint, save_state_dict,
                                   vlp_state_dict_from_flax)
from medvill_torch.data import retrieval as tret
from medvill_torch.data import tokenization as ttok
from medvill_torch.models.cnn_bert import CNNBert as TorchCNNBert
from medvill_torch.models.cxrbert import CXRBERT as TorchCXRBERT
from medvill_torch.models.mmbt import MultimodalBertClf
from medvill_torch.models.seq2seq import VLPForPreTraining
from medvill_torch.ops.flash_attention import (FAMILY_PRETRAIN,
                                               make_attention_fn)
from medvill_torch.train import retrieve as tretrieve
from medvill_torch.utils.logging import create_logger
from medvill_tpu.core import torch_init as jinit
from medvill_tpu.core.config import (BertConfig, ImageEncoderConfig,
                                     RetrievalConfig)
from medvill_tpu.data import retrieval as jret
from medvill_tpu.data.pretrain import BatchLoader
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.models.cnn_bert import CNNBert as JaxCNNBert
from medvill_tpu.models.cxrbert import CXRBERT as JaxCXRBERT
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import retrieve as jretrieve
from medvill_tpu.train.pretrain import TrainState
from tests.torch_port_support import perturb, random_batch_stats

IMG = 64
VOCAB = 64
N = 4  # the trunk's fibers at 64 px
WORDS = [f"word{i}" for i in range(50)]


def jax_cfg(flash=False, compute_dtype="float32", **kw):
    bert = dataclasses.replace(BertConfig.test_tiny(vocab_size=VOCAB),
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0,
                               compute_dtype=compute_dtype)
    image = ImageEncoderConfig(img_size=IMG, num_image_embeds=N)
    kw.setdefault("batch_size", 3)
    return RetrievalConfig(bert=bert, image=image, seq_len=7, img_size=IMG,
                           use_flash_attention=flash, **kw)


def port_cfg(cfg: RetrievalConfig) -> tcfg.RetrievalConfig:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
         if f.name != "mesh_shape"}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(cfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(cfg.image))
    return tcfg.RetrievalConfig(**d)


def image_of(path: str) -> np.ndarray:
    """A fixed uint8 image per path: both datasets load the same pixels."""
    rng = np.random.default_rng(zlib.crc32(path.encode()))
    return rng.integers(0, 256, (IMG, IMG, 3), dtype=np.uint8)


def datasets(records, cfg, **kw):
    """(JAX dataset, port dataset) over the same records and seed."""
    vocab = build_vocab(WORDS)
    return (jret.CXRRetrievalDataset(records, BertTokenizer(vocab), cfg,
                                     image_loader=image_of, **kw),
            tret.CXRRetrievalDataset(records,
                                     ttok.BertTokenizer(ttok.build_vocab(
                                         WORDS)),
                                     port_cfg(cfg), image_loader=image_of,
                                     **kw))


def assert_same(got, want, what=""):
    """Equal keys; arrays equal bit for bit, with their dtype."""
    assert sorted(got) == sorted(want), what
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


def pair_batches(cfg, n, seed, cxr_bert=True):
    """``n`` collated train batches (3 pairs, 6 rows) from the JAX
    dataset."""
    recs = jret.synthetic_retrieval_records(3 * n, seed=seed)
    jds, _ = datasets(recs, cfg, is_train=True, seed=seed, cxr_bert=cxr_bert)
    return [jret.collate_pairs([jds[3 * i + j] for j in range(3)])
            for i in range(n)]


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --- data ------------------------------------------------------------------

@pytest.mark.parametrize("label_conditioned", [True, False],
                         ids=["label-conditioned", "any-negative"])
@pytest.mark.parametrize("cxr_bert", [True, False], ids=["cxrbert", "cnn"])
def test_train_pairs_bit_identical(cxr_bert, label_conditioned):
    """(idx, positive, negative) of every record, the sequential stream and
    per-sample RNGs (``fetch(idx, rng)``, the multi-worker loader's), and
    collate_pairs: equal to JAX's bit for bit."""
    cfg = jax_cfg()
    recs = jret.synthetic_retrieval_records(12, n_labels=3, seed=1)
    assert tret.synthetic_retrieval_records(12, n_labels=3, seed=1) == recs
    jds, tds = datasets(recs, cfg, is_train=True, seed=5,
                        label_conditioned=label_conditioned,
                        cxr_bert=cxr_bert)
    width = cfg.seq_len + (1 if cxr_bert else 2)
    samples, jax_samples = [], []
    for i in [3, 0, 11, 3, 7, 5, 5, 1]:
        (ji, jp, jn), (ti, tp, tn) = jds[i], tds[i]
        assert ji == ti == i
        assert_same(tp, jp, f"pos {i}")
        assert_same(tn, jn, f"neg {i}")
        assert jp["input_txt"].shape == (width,)
        assert jp["is_aligned"] == 1 and jn["is_aligned"] == 0
        samples.append((ti, tp, tn))
        jax_samples.append((ji, jp, jn))
    assert any(not np.array_equal(p["input_txt"], n["input_txt"])
               or not np.array_equal(p["image"], n["image"])
               for _, p, n in samples)
    for i in (2, 9):
        (_, jp, jn), (_, tp, tn) = (jds.fetch(i, random.Random(f"7/{i}")),
                                    tds.fetch(i, random.Random(f"7/{i}")))
        assert_same(tp, jp)
        assert_same(tn, jn)
    assert_same(tret.collate_pairs(samples),
                jret.collate_pairs(jax_samples))


@pytest.mark.parametrize("cxr_bert", [True, False], ids=["cxrbert", "cnn"])
def test_label_fallback_and_refusals(cxr_bert):
    """Every record shares one label: after 300 tries both datasets take a
    same-label different record as the negative (equal bit for bit, not the
    positive itself); fewer than 2 records is refused by both."""
    cfg = jax_cfg()
    recs = jret.synthetic_retrieval_records(5, n_labels=1, seed=2)
    jds, tds = datasets(recs, cfg, is_train=True, seed=3, cxr_bert=cxr_bert)
    for i in range(5):
        (_, jp, jn), (_, tp, tn) = jds[i], tds[i]
        assert_same(tp, jp)
        assert_same(tn, jn)
        assert not (np.array_equal(tn["input_txt"], tp["input_txt"])
                    and np.array_equal(tn["image"], tp["image"]))
    jds, tds = datasets(recs[:1], cfg, is_train=True, cxr_bert=cxr_bert)
    for ds in (jds, tds):
        with pytest.raises(ValueError, match=">= 2 records"):
            ds[0]


@pytest.mark.parametrize("cxr_bert", [True, False], ids=["cxrbert", "cnn"])
def test_eval_rows_bit_identical(cxr_bert):
    """Pool rows keyed ``text`` or ``txt``, ``is_aligned`` as a list or an
    int, with their index; rows without text or without ``is_aligned`` are
    refused by both."""
    cfg = jax_cfg()
    recs = tret.synthetic_retrieval_records(6, seed=4, eval_pool=3)
    assert jret.synthetic_retrieval_records(6, seed=4, eval_pool=3) == recs
    recs[1]["txt"] = recs[1].pop("text")
    recs[2]["is_aligned"] = 1
    jds, tds = datasets(recs, cfg, is_train=False, cxr_bert=cxr_bert)
    for i in range(6):
        assert_same(tds[i], jds[i], f"row {i}")
        assert tds[i]["index"] == i
    assert [int(tds[i]["is_aligned"]) for i in range(6)] == [1, 0, 1, 1, 0, 0]
    for bad, match in (({"img": "a.jpg", "is_aligned": [1]}, "'text'"),
                       ({"img": "a.jpg", "text": "word1"}, "is_aligned")):
        for ds in datasets([bad], cfg, is_train=False, cxr_bert=cxr_bert):
            with pytest.raises(ValueError, match=match):
                ds[0]


# --- CXRBERT -----------------------------------------------------------------

@pytest.fixture(scope="module")
def cxr():
    """Perturbed CXRBERT weights and random BN statistics (the trunk
    perturbed less, as test_torch_port_pretrain.py's)."""
    cfg = jax_cfg()
    model = jretrieve.build_model(cfg)
    L = cfg.seq_len + 1
    init = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((2, 1), jnp.int32),
        jnp.zeros((2, L), jnp.int32), jnp.zeros((2, 2), jnp.int32),
        jnp.ones((2, L), jnp.int32), jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, 1), jnp.int32), pixel_indices=jnp.arange(N)))(
            jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    params = perturb(init["params"], rng, 0.05)
    params["enc"]["img_encoder"] = perturb(init["params"]["enc"]
                                           ["img_encoder"], rng, 0.02)
    # a larger ITM head spreads the alignment scores apart
    params["itm"] = perturb(init["params"]["itm"], rng, 1.0)
    return model, {"params": params,
                   "batch_stats": random_batch_stats(init["batch_stats"],
                                                     rng)}


def torch_cxrbert(cfg, v) -> TorchCXRBERT:
    pc = port_cfg(cfg)
    model = TorchCXRBERT(pc.bert, pc.image)
    model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                           cxrbert_state_dict_from_flax(
                               v["params"], v["batch_stats"]).items()})
    return model


ARGS = ("cls_tok", "input_txt", "mask_spec", "segment", "image", "sep_tok")


@pytest.mark.parametrize("flash", [True, False],
                         ids=["attention-kernel", "dense-bias"])
def test_itm_forward_matches_jax(cxr, flash):
    """Eval-mode ITM logits (running BN statistics) of 6 rows, the port on
    the attention kernel's path (its plain version here) and on the dense
    bias, against JAX's reference attention: within 1e-5 (f32)."""
    model, v = cxr
    cfg = jax_cfg()
    batch = pair_batches(cfg, 1, seed=7)[0]
    want = jax.jit(lambda v, *a: model.apply(
        v, *a, pixel_indices=jnp.arange(N), deterministic=True,
        method=JaxCXRBERT.itm_forward))(
            v, *[jnp.asarray(batch[k]) for k in ARGS])
    tm = torch_cxrbert(cfg, v).eval()
    tb = torch_batch(batch)
    fn = (make_attention_fn(tb["mask_spec"], N + 2, family=FAMILY_PRETRAIN)
          if flash else None)
    with torch.no_grad():
        got = tm.itm_forward(*[tb[k] for k in ARGS],
                             pixel_indices=torch.arange(N), attention_fn=fn)
    assert got.dtype == torch.float32 and got.shape == (6, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def grad_capture():
    """An optax transformation whose state after an update is the
    gradient itself and whose update is zero, so JAX's own train step hands
    back its gradients exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_train_step_matches_jax(cxr):
    """JAX's make_train_step (reference attention, frozen trunk through
    stop_frozen, train-mode BatchNorm) against the port's on the kernel
    path (plain versions) and on the dense bias: loss and accuracy 1e-5,
    every trainable gradient within 1e-3 of its tensor's largest entry
    (floor 1e-3; the train-mode trunk's features differ by ~2e-3 of scale
    between the packages at this batch, see test_torch_port_pretrain.py),
    the trunk's and the MLM head's gradients zero in JAX and absent in the
    port, and the running statistics after the step within 1e-3."""
    model, v = cxr
    cfg = jax_cfg()
    batch = pair_batches(cfg, 1, seed=8)[0]
    state = TrainState(step=jnp.zeros([], jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=grad_capture().init(v["params"]))
    new, m = jax.jit(jretrieve.make_train_step(model, grad_capture(), cfg))(
        state, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    want = cxrbert_state_dict_from_flax(new.opt_state, v["batch_stats"])
    new_stats = cxrbert_state_dict_from_flax(v["params"], new.batch_stats)
    assert not any(np.abs(a).max() for k, a in want.items()
                   if k.startswith("enc.img_encoder.")
                   and not k.endswith(("running_mean", "running_var",
                                       "num_batches_tracked")))
    for flash in (True, False):
        c = dataclasses.replace(cfg, use_flash_attention=flash)
        tm = torch_cxrbert(c, v)
        loss, got_m = tretrieve.loss_and_metrics(
            tm, torch_batch(batch), None, torch.arange(N), port_cfg(c))
        loss.backward()
        for k in ("loss", "acc"):
            np.testing.assert_allclose(got_m[k].item(), float(m[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        n = 0
        for name, p in tm.named_parameters():
            if name.startswith("enc.img_encoder."):
                assert p.grad is None and not p.requires_grad
                continue
            w = want[name]
            if p.grad is None:  # the MLM head: no loss reads it
                assert name.startswith("mlm.") and not np.abs(w).any()
                continue
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=0,
                atol=1e-3 * max(np.abs(w).max(), 1e-3), err_msg=name)
            n += 1
        # 2 layers x 16; embeddings 5, projection 2, pooler 2, ITM 2
        assert n == 2 * 16 + 11
        for k, t in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), new_stats[k],
                                           rtol=1e-3, atol=1e-3, err_msg=k)


def test_three_adamw_steps_match_jax(cxr):
    """The JAX CLI's optimizer (AdamW lr 1e-3 masked off the frozen trunk)
    and train step against the port's init_state + make_train_step over 3
    batches: parameters within 5e-4 (one Adam step moves an entry by up to
    1e-3; see test_torch_port_pretrain.py), BN statistics 1e-3; the 46
    trainable tensors moved (and the decoder tied to the word table), the
    trunk not; the MLM head gets no gradient and does not move (AdamW's
    decay is 0)."""
    model, v = cxr
    cfg = jax_cfg(lr=1e-3)
    tx = joptim.masked_trainable(
        joptim.adamw(cfg.lr),
        lambda p: jresnet.cnn_freeze_mask(p, ("enc", "img_encoder")))
    state = TrainState(step=jnp.zeros([], jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]))
    step = jax.jit(jretrieve.make_train_step(model, tx, cfg))
    data = pair_batches(cfg, 3, seed=9)
    for b in data:
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
    pc = port_cfg(dataclasses.replace(cfg, use_flash_attention=True))
    ts = tretrieve.init_state(pc, device="cpu")
    ts.model.load_state_dict(torch_cxrbert(cfg, v).state_dict())
    train_step = tretrieve.make_train_step(pc)
    gen = torch.Generator().manual_seed(0)
    losses = [train_step(ts, torch_batch(b), gen)["loss"].item()
              for b in data]
    assert ts.step == 3 and all(np.isfinite(losses))
    want = cxrbert_state_dict_from_flax(state.params, state.batch_stats)
    before = cxrbert_state_dict_from_flax(v["params"], v["batch_stats"])
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
    assert moved == 2 * 16 + 9 + 2 + 1  # the tied decoder listed twice


def test_score_step_and_eval_match_jax(cxr, tmp_path):
    """make_score_step + run_retrieval_eval over 2 pools of 6 candidates in
    batches of 5 (a tail batch): scores within 1e-5, no two of a pool
    closer than 10x the packages' largest score difference, so both rank
    them alike; Hits@k, MRR,
    R/P@k equal and the rank dumps equal line for line (one per query, its
    record resolved);
    an eval_len_size that leaves trailing candidates warns in both."""
    model, v = cxr
    cfg = jax_cfg(batch_size=5, eval_len_size=6)
    recs = tret.synthetic_retrieval_records(12, seed=10, eval_pool=6)
    recs[7]["is_aligned"] = [1]
    jds, _ = datasets(recs, cfg, is_train=False)
    batches = list(BatchLoader(jds, 5, shuffle=False, drop_last=False))
    assert [len(b["index"]) for b in batches] == [5, 5, 2]
    jscore = jax.jit(jretrieve.make_score_step(model, cfg))
    state = TrainState(step=jnp.zeros([], jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], opt_state=None)
    tm = torch_cxrbert(cfg, v).eval()
    pc = port_cfg(cfg)
    tscore = tretrieve.make_score_step(pc)
    want_s = np.concatenate([np.asarray(jscore(
        state, jax.tree_util.tree_map(jnp.asarray, b))) for b in batches])
    got_s = np.concatenate([tscore(tm, torch_batch(b)).numpy()
                            for b in batches])
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    err = np.abs(got_s - want_s).max()
    for pool in want_s.reshape(2, 6):
        assert np.diff(np.sort(pool)).min() > 10 * err, pool
    out = {}
    for name, run in (("jax", lambda p, n: jretrieve.run_retrieval_eval(
            jscore, state, batches, n, "i2t", rank_dump_path=p,
            records=jds.data)),
                      ("port", lambda p, n: tretrieve.run_retrieval_eval(
                          tscore, tm, batches, n, "i2t", rank_dump_path=p,
                          records=jds.data))):
        path = str(tmp_path / f"{name}.json")
        res = run(path, 6)
        assert res.pop("rank_dump") == path
        with open(path) as f:
            out[name] = (res, f.read())
        with pytest.warns(UserWarning, match="2 trailing candidates"):
            run(None, 5)
    assert out["port"] == out["jax"]
    lines = [json.loads(line) for line in out["port"][1].splitlines()]
    # one line per query: its best-ranked aligned candidate
    assert len(lines) == 2 and lines[1]["Result"] == recs[6]


# --- CNN_BERT (float64) ------------------------------------------------------

def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def cnn():
    """Perturbed CNN_BERT weights and random BN statistics, float64, the
    config in float64 compute."""
    cfg = jax_cfg(compute_dtype="float64")
    model = JaxCNNBert(cfg.bert, n_classes=2)
    L2 = cfg.seq_len + 2
    with jax.enable_x64():
        init = jax.jit(lambda key: model.init(
            {"params": key}, jnp.zeros((2, L2), jnp.int32),
            jnp.ones((2,), jnp.int32), jnp.zeros((2, L2), jnp.int32),
            jnp.zeros((2, IMG, IMG, 3))))(jax.random.PRNGKey(11))
    rng = np.random.default_rng(11)
    params = perturb(init["params"], rng, 0.05)
    params["img_encoder"] = perturb(init["params"]["img_encoder"], rng, 0.02)
    stats = random_batch_stats(init["batch_stats"], rng)
    return cfg, model, {"params": _f64(params), "batch_stats": _f64(stats)}


def cnn_batches(cfg, n, seed):
    """Train batches of the CNN branch with float64 ImageNet-normalized
    images (float input skips both trunks' uint8 normalization)."""
    from medvill_torch.data.images import IMAGENET_MEAN, IMAGENET_STD

    out = []
    for b in pair_batches(cfg, n, seed, cxr_bert=False):
        b = dict(b)
        b["image"] = ((b["image"] / 255.0 - IMAGENET_MEAN.astype(np.float64))
                      / IMAGENET_STD.astype(np.float64))
        out.append(b)
    return out


def torch_cnn(cfg, v) -> TorchCNNBert:
    model = TorchCNNBert(port_cfg(cfg).bert).double()
    model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                           cnn_bert_state_dict_from_flax(
                               v["params"], v["batch_stats"]).items()})
    return model


def test_cnn_bert_forward_and_gradients_match_jax_float64(cnn):
    """Float64 on both sides but where JAX itself computes in f32: the
    fusion casts both features to f32 and the loss casts the logits to f32,
    in both packages.  Eval-mode logits within 1e-8 relative; JAX's
    make_cnn_train_step (the trunk trained, train-mode BatchNorm) against
    the port's cnn_loss_and_metrics: loss within 1e-7 relative (its f32
    logsumexp), every one of the 159 trunk and 39 text-and-fusion
    gradients within 1e-6 of its tensor's largest entry (a key bias, whose
    exact gradient is 0, of its key weights'): the gradient leaves the f32
    loss with f32 rounding, ~6e-8 relative, which an f32 comparison of the
    trunk could not resolve (a ReLU input within rounding of 0 moves a
    tensor by 25-48% of its scale, test_torch_port_classification.py).
    Running statistics 1e-8 relative."""
    cfg, model, v = cnn
    batch = cnn_batches(cfg, 1, seed=12)[0]
    with jax.enable_x64():
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        want_logits = np.asarray(jax.jit(lambda v, b: model.apply(
            v, b["input_txt"], b["attn_len"], b["segment"], b["image"],
            deterministic=True))(v, jb))
        state = TrainState(step=jnp.zeros([], jnp.int32),
                           params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=grad_capture().init(v["params"]))
        new, m = jax.jit(jretrieve.make_cnn_train_step(
            model, grad_capture(), cfg))(state, jb, jax.random.PRNGKey(0))
        want = cnn_bert_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, new.opt_state),
            v["batch_stats"])
        new_stats = cnn_bert_state_dict_from_flax(
            v["params"], jax.tree_util.tree_map(np.asarray,
                                                new.batch_stats))
        want_loss = float(m["loss"])
    tm = torch_cnn(cfg, v)
    tb = torch_batch(batch)
    with torch.no_grad():
        logits = tm.eval()(tb["input_txt"], tb["attn_len"], tb["segment"],
                           tb["image"])
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-8)
    loss, got_m = tretrieve.cnn_loss_and_metrics(tm.train(), tb, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-7)
    assert got_m["acc"].item() == pytest.approx(float(m["acc"]))
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert len(grads) == 159 + 2 * 16 + 5 + 2 + 2
    for name, g in grads.items():
        w = want[name]
        scale = np.abs(want[name[:-len("bias")] + "weight"] if name.endswith(
            "attention.self.key.bias") else w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * scale,
                                   err_msg=name)
    for k, t in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new_stats[k], rtol=1e-8,
                                       atol=1e-12, err_msg=k)


def test_cnn_bert_three_adamw_steps_match_jax(cnn):
    """The CLI's AdamW (lr 1e-3) through JAX's make_cnn_train_step and the
    port's init_state(cxr_bert=False) + make_cnn_train_step, 3 batches in
    f32 with the trunk's parameters held (a masked optimizer in JAX,
    ``requires_grad`` off in the port; its BatchNorm still in train mode):
    parameters within 5e-4 (one Adam step moves an entry by up to 1e-3;
    the train-mode trunk's features differ by ~2e-3 of scale between the
    packages, see test_torch_port_pretrain.py), statistics 1e-3; the 41
    text and fusion tensors moved, the trunk's 159 not.  Several steps
    cannot be held tensor by tensor with the trunk trained, even in
    float64: JAX computes attention, the pooler's tanh and the loss in
    f32, Adam's per-element normalization turns that rounding into
    different updates of near-zero gradient entries, and the train-mode
    trunk spreads them (2.8e-4 of a 1e-3 step apart after 3 steps).  The
    trained trunk under AdamW is held alone in float64 by
    test_trunk_three_adamw_steps_match_jax_float64."""
    cfg, model, v = cnn
    cfg = dataclasses.replace(cfg, lr=1e-3, bert=dataclasses.replace(
        cfg.bert, compute_dtype="float32"))
    model = JaxCNNBert(cfg.bert, n_classes=2)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   v["batch_stats"])
    data = pair_batches(cfg, 3, seed=13, cxr_bert=False)
    tx = joptim.masked_trainable(
        joptim.adamw(cfg.lr),
        lambda p: jresnet.cnn_freeze_mask(p, ("img_encoder", "trunk")))
    state = TrainState(step=jnp.zeros([], jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    step = jax.jit(jretrieve.make_cnn_train_step(model, tx, cfg))
    for b in data:
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
    want = cnn_bert_state_dict_from_flax(state.params, state.batch_stats)
    ts = tretrieve.init_state(port_cfg(cfg), cxr_bert=False, device="cpu")
    ts.model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                              cnn_bert_state_dict_from_flax(
                                  params, stats).items()})
    ts.model.img_enc.requires_grad_(False)
    before = {k: t.clone() for k, t in ts.model.state_dict().items()}
    train_step = tretrieve.make_cnn_train_step(port_cfg(cfg))
    gen = torch.Generator().manual_seed(0)
    for b in data:
        train_step(ts, torch_batch(b), gen)
    moved = held = 0
    for k, t in ts.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)
            continue
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=5e-4,
                                   err_msg=k)
        if k.startswith("img_enc."):
            held += torch.equal(t, before[k])
        else:
            moved += not torch.equal(t, before[k])
    assert (moved, held) == (2 * 16 + 5 + 2 + 2, 159)


def test_trunk_three_adamw_steps_match_jax_float64(cnn):
    """The CNN_BERT image encoder alone (the trunk and the mean over its
    fibers, train-mode BatchNorm) under 3 AdamW steps (lr 1e-3) in float64
    on both sides, the loss a weighted sum of its [B, 2048] output: every
    parameter within 1e-6, under 1e-3 of one step's move (Adam divides each
    gradient entry by its own running magnitude, so entries near its eps
    carry the packages' 1e-13 gradient differences into their updates, and
    the train-mode net spreads them: 3.5e-7 measured), every running
    statistic within 1e-6 of its tensor's largest entry; all 159
    parameters moved."""
    from medvill_torch.models.cnn_bert import ImgGlobalEncoder as TorchIGE
    from medvill_torch.train import optim as toptim
    from medvill_tpu.models.cnn_bert import ImgGlobalEncoder as JaxIGE

    _, _, v = cnn
    data = [(b["image"][:3], np.random.default_rng(i).standard_normal(
        (3, 2048))) for i, b in enumerate(cnn_batches(jax_cfg(), 3,
                                                        seed=14))]
    enc = JaxIGE(dtype=jnp.float64)
    with jax.enable_x64():
        def loss_fn(params, stats, x, r):
            vec, upd = enc.apply({"params": {"trunk": params},
                                  "batch_stats": {"trunk": stats}}, x,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(vec * r), upd["batch_stats"]["trunk"]

        grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        tx = joptim.adamw(1e-3)
        params = v["params"]["img_encoder"]["trunk"]
        stats = v["batch_stats"]["img_encoder"]["trunk"]
        opt = tx.init(params)
        for x, r in data:
            (_, stats), g = grad(params, stats, x, r)
            updates, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, updates)
        want = cnn_bert_state_dict_from_flax(
            {"txt_encoder": v["params"]["txt_encoder"],
             "img_encoder": {"trunk": jax.tree_util.tree_map(np.asarray,
                                                             params)}},
            {"img_encoder": {"trunk": jax.tree_util.tree_map(np.asarray,
                                                             stats)}})
    trunk = TorchIGE(dtype=torch.float64).double()
    trunk.load_state_dict({k[len("img_enc."):]: v for k, v in
                           torch_cnn(jax_cfg(), v).state_dict().items()
                           if k.startswith("img_enc.")})
    before = {k: t.clone() for k, t in trunk.state_dict().items()}
    opt = toptim.adamw(trunk.parameters(), 1e-3)
    for x, r in data:
        opt.zero_grad()
        (trunk(torch.from_numpy(x), train=True)
         * torch.from_numpy(r)).sum().backward()
        opt.step()
    moved = 0
    for k, t in trunk.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        w = want["img_enc." + k]
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(
            t.numpy(), w, rtol=0,
            atol=1e-6 * np.abs(w).max() if stat else 1e-6, err_msg=k)
        if not k.endswith(("running_mean", "running_var")):
            moved += not torch.equal(t, before[k])
    assert moved == 159


# --- torch_init and restore_pretrained -----------------------------------------

def _jax_cxrbert_init(model, seed):
    cfg = jax_cfg()
    L = cfg.seq_len + 1
    return jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((2, 1), jnp.int32),
        jnp.zeros((2, L), jnp.int32), jnp.zeros((2, 2), jnp.int32),
        jnp.ones((2, L), jnp.int32), jnp.zeros((2, IMG, IMG, 3)),
        jnp.zeros((2, 1), jnp.int32), pixel_indices=jnp.arange(N)))(
            jax.random.PRNGKey(seed))


def _equal_state(model, want: dict, skip=("num_batches_tracked",)):
    own = model.state_dict()
    for k, t in own.items():
        if k.endswith(skip):
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[k],
                                                            np.float32),
                                      err_msg=k)


def test_cxrbert_file_loads_as_jax_loads_it(cxr, tmp_path):
    """A CXRBERT file in the reference layout, under ``module.`` inside
    ``{"state_dict": ...}`` and with a 40-row position table: JAX's
    init_cxrbert_from_torch and the port's load the same tensors (the table
    resized to 512 rows by repeating its last row); the port's own
    model.<epoch>.bin loads back equal to load_cxrbert_checkpoint."""
    model, v = cxr
    sd = cxrbert_state_dict_from_flax(v["params"], v["batch_stats"])
    pos = "enc.txt_embeddings.position_embeddings.weight"
    sd[pos] = sd[pos][:40]
    path = str(tmp_path / "cxrbert.bin")
    torch.save({"state_dict": {"module." + k: torch.from_numpy(np.array(a))
                               for k, a in sd.items()}}, path)
    init = _jax_cxrbert_init(model, 12)
    params, stats = jinit.init_cxrbert_from_torch(init["params"],
                                                  init["batch_stats"], path)
    want = cxrbert_state_dict_from_flax(params, stats)
    np.testing.assert_array_equal(want[pos][40:],
                                  np.repeat(sd[pos][-1:], 472, 0))
    pc = port_cfg(jax_cfg())
    tm = TorchCXRBERT(pc.bert, pc.image)
    loaded = tinit.init_cxrbert_from_torch(tm, path)
    _equal_state(tm, want)
    own = [k for k in tm.state_dict() if not k.endswith(
        ("num_batches_tracked", "mlm.predictions.decoder.weight"))]
    assert loaded == sorted(own)
    port_file = str(tmp_path / "model.0.bin")
    torch.save(tm.state_dict(), port_file)
    again = TorchCXRBERT(pc.bert, pc.image)
    tinit.init_cxrbert_from_torch(again, port_file)
    strict = TorchCXRBERT(pc.bert, pc.image)
    load_cxrbert_checkpoint(strict, port_file)
    for k, t in strict.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again.state_dict()[k], t), k


def _torchvision_sd(trunk_sd: dict) -> dict:
    """The port trunk's state dict under torchvision names, with the
    classifier a torchvision file carries."""
    back = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
            "6": "layer3", "7": "layer4"}
    out = {}
    for k, t in trunk_sd.items():
        idx, _, tail = k[len("model."):].partition(".")
        out[f"{back[idx]}.{tail}"] = t
    out["fc.weight"] = torch.zeros(1000, 2048)
    out["fc.bias"] = torch.zeros(1000)
    return out


def test_torchvision_resnet_and_hf_bert_load_as_jax_loads_them(cxr,
                                                              tmp_path):
    """A torchvision ResNet-50 file with the trunk under ``enc.model.`` and
    an HF BERT file (``bert.*``, 32 positions, the MLM head's keys beside)
    into a CXRBERT, and the HF file into the VLP (``enc_key`` "bert": the
    model itself, 2 token types expanded to 6) and into MMBT: each model
    holds what JAX's init_resnet_from_torch / init_bert_from_torch put in
    its tree, and everything else keeps its values."""
    model, v = cxr
    gen = torch.Generator().manual_seed(3)
    src = TorchCXRBERT(port_cfg(jax_cfg()).bert, port_cfg(jax_cfg()).image)
    for t in src.state_dict().values():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen))
    tv = _torchvision_sd({k: t for k, t in
                          src.enc.img_encoder.state_dict().items()})
    tv_path = str(tmp_path / "resnet50.pth")
    torch.save({"enc.model." + k: t for k, t in tv.items()}, tv_path)
    hf = {"bert.embeddings." + k[len("txt_embeddings."):]: t
          for k, t in src.enc.state_dict().items()
          if k.startswith("txt_embeddings.")}
    hf.update({"bert." + k: t for k, t in src.enc.state_dict().items()
               if k.startswith(("encoder.", "pooler."))})
    hf["bert.embeddings.position_embeddings.weight"] = hf[
        "bert.embeddings.position_embeddings.weight"][:32]
    hf["cls.predictions.bias"] = torch.zeros(VOCAB)
    hf_path = str(tmp_path / "pytorch_model.bin")
    torch.save(hf, hf_path)

    params, stats = jinit.init_resnet_from_torch(
        v["params"], v["batch_stats"], tv_path,
        trunk_path=("enc", "img_encoder"))
    params = jinit.init_bert_from_torch(params, hf_path, enc_key="enc",
                                        num_layers=2)
    want = cxrbert_state_dict_from_flax(params, stats)
    tm = torch_cxrbert(jax_cfg(), v)
    trunk_keys = tinit.init_resnet_from_torch(tm, tv_path)
    assert len(trunk_keys) == 159 + 2 * 53
    tinit.init_bert_from_torch(tm, hf_path, enc_key="enc", num_layers=2)
    _equal_state(tm, want)

    from tests.torch_port_support import finetune_config, jax_vlp, port_config
    fcfg = finetune_config()
    _, vv = jax_vlp(fcfg)
    jp = jinit.init_bert_from_torch(vv["params"], hf_path, enc_key="bert",
                                    num_layers=2)
    bert, image = port_config(fcfg)
    vlp = VLPForPreTraining(bert, image, len_vis_input=fcfg.len_vis_input)
    vlp.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                         vlp_state_dict_from_flax(
                             vv["params"], vv["batch_stats"]).items()})
    tinit.init_bert_from_torch(vlp, hf_path, enc_key="bert", num_layers=2)
    _equal_state(vlp, vlp_state_dict_from_flax(jp, vv["batch_stats"]))
    types = vlp.txt_embeddings.token_type_embeddings.weight
    assert torch.equal(types[4], types[0]) and torch.equal(types[5],
                                                           types[1])

    mmbt = MultimodalBertClf(port_cfg(jax_cfg()).bert,
                             port_cfg(jax_cfg()).image, 3)
    before = {k: t.clone() for k, t in mmbt.state_dict().items()}
    tinit.init_resnet_from_torch(mmbt, tv_path, ("enc", "img_encoder"))
    tinit.init_bert_from_torch(mmbt, hf_path, enc_key="enc")
    after = mmbt.state_dict()
    for k, t in tm.state_dict().items():
        if k.startswith("enc.") and k in after and not k.startswith(
                "enc.img_embeddings") and not k.endswith(
                    "num_batches_tracked"):
            assert torch.equal(after[k], t), k
    for k in ("clf.weight", "enc.img_embeddings.img_embeddings.weight"):
        assert torch.equal(after[k], before[k])


def test_cnn_bert_file_loads_as_jax_loads_it(cnn, tmp_path):
    """A CNN_BERT file (``module.``-prefixed): JAX's init_cnn_bert_from_torch
    and the port's load the same tensors; load_cnn_bert_checkpoint reads
    the port's own save strictly."""
    cfg, model, v = cnn
    sd = cnn_bert_state_dict_from_flax(v["params"], v["batch_stats"])
    path = str(tmp_path / "cnn_bert.bin")
    torch.save({"module." + k: torch.from_numpy(np.asarray(a, np.float32))
                for k, a in sd.items()}, path)
    f32 = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, compute_dtype="float32"))
    init = jax.jit(lambda key: JaxCNNBert(f32.bert, n_classes=2).init(
        {"params": key}, jnp.zeros((2, 9), jnp.int32),
        jnp.ones((2,), jnp.int32), jnp.zeros((2, 9), jnp.int32),
        jnp.zeros((2, IMG, IMG, 3))))(jax.random.PRNGKey(1))
    params, stats = jinit.init_cnn_bert_from_torch(init["params"],
                                                   init["batch_stats"], path)
    tm = TorchCNNBert(port_cfg(f32).bert)
    loaded = tinit.init_cnn_bert_from_torch(tm, path)
    assert len(loaded) == len([k for k in tm.state_dict()
                               if not k.endswith("num_batches_tracked")])
    _equal_state(tm, cnn_bert_state_dict_from_flax(params, stats))
    own = str(tmp_path / "model.0.bin")
    torch.save(tm.state_dict(), own)
    again = TorchCNNBert(port_cfg(f32).bert)
    assert load_cnn_bert_checkpoint(again, own) == []
    for k, t in again.state_dict().items():
        assert torch.equal(t, tm.state_dict()[k]), k


def test_wrong_files_fail_loudly(cxr, tmp_path):
    """A stem of the wrong shape, a trunk file lacking tensors, a file of
    another model's layout, and an HF file with fewer layers than the
    model: the port raises ValueError where JAX raises."""
    model, v = cxr
    pc = port_cfg(jax_cfg())
    tm = TorchCXRBERT(pc.bert, pc.image)
    bad_stem = str(tmp_path / "bad.pth")
    torch.save({"conv1.weight": torch.zeros(64, 3, 3, 3)}, bad_stem)
    with pytest.raises((ValueError, KeyError)):
        jinit.init_resnet_from_torch(v["params"], v["batch_stats"], bad_stem)
    with pytest.raises(ValueError, match="lacks"):
        tinit.init_resnet_from_torch(tm, bad_stem)
    full = _torchvision_sd(dict(tm.enc.img_encoder.state_dict()))
    full["conv1.weight"] = torch.zeros(64, 3, 3, 3)
    torch.save(full, bad_stem)
    with pytest.raises(ValueError):
        jinit.init_resnet_from_torch(v["params"], v["batch_stats"], bad_stem)
    with pytest.raises(ValueError, match="shape"):
        tinit.init_resnet_from_torch(tm, bad_stem)
    cnn_file = str(tmp_path / "cnn.bin")
    torch.save({"txt_enc.encoder.layer.0.output.dense.bias":
                torch.zeros(32)}, cnn_file)
    with pytest.raises(ValueError, match="not a CXRBERT"):
        jinit.init_cxrbert_from_torch(v["params"], v["batch_stats"],
                                      cnn_file)
    with pytest.raises(ValueError, match="not a CXRBERT"):
        tinit.init_cxrbert_from_torch(tm, cnn_file)
    cxr_file = str(tmp_path / "cxr.bin")
    save_state_dict(cxrbert_state_dict_from_flax(v["params"],
                                                 v["batch_stats"]), cxr_file)
    with pytest.raises(ValueError, match="not a CNN_BERT"):
        tinit.init_cnn_bert_from_torch(TorchCNNBert(pc.bert), cxr_file)
    one_layer = {k: t for k, t in torch.load(cxr_file).items()
                 if not k.startswith("enc.encoder.layer.1.")}
    torch.save(one_layer, cxr_file)
    with pytest.raises(ValueError, match="lacks encoder.layer.1"):
        tinit.init_cxrbert_from_torch(tm, cxr_file)


def test_restore_pretrained_dispatch(tmp_path):
    """A file, a directory with pytorch_model.bin, and a run directory
    (its latest model.<epoch>.bin) go through the loader; any other path
    raises FileNotFoundError, as JAX's does."""
    logger = create_logger()
    seen = []

    def loader(model, path):
        seen.append(os.path.relpath(path, tmp_path))

    (tmp_path / "hf").mkdir()
    (tmp_path / "run").mkdir()
    (tmp_path / "empty").mkdir()
    for name in ("w.bin", "hf/pytorch_model.bin", "run/model.0.bin",
                 "run/model.2.bin", "run/model.10.bin"):
        (tmp_path / name).write_bytes(b"")
    for path in ("w.bin", "hf", "run"):
        restore_pretrained(None, str(tmp_path / path), loader, logger)
    assert seen == ["w.bin", "hf/pytorch_model.bin", "run/model.10.bin"]
    for path in ("empty", "missing"):
        with pytest.raises(FileNotFoundError, match="neither"):
            restore_pretrained(None, str(tmp_path / path), loader, logger,
                               "load_pretrained_model")
    assert jinit.is_torch_checkpoint(str(tmp_path / "hf"))
    assert not tinit.is_torch_checkpoint(str(tmp_path / "run"))
