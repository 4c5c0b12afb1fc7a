"""The port's MMBT classification model and step against the JAX
package's on the same numpy inputs and the same weights (carried through
mmbt_state_dict_from_flax): the pool encoders' adaptive pooling, the
logits of the full-fiber and pool encoders on the attention kernel path
(the JAX side runs its Pallas kernel in interpret mode) and on the dense
bias, the trunk's gradients with the trunk trained, three BertAdam steps
with weighted BCE, softmax CE and accumulation 2, the freeze phases, and
the trained trunk alone in float64 (its gradients and three BertAdam
steps, tensor by tensor).
Dropout is 0: the two packages draw different dropout bits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import mmbt_state_dict_from_flax
from medvill_torch.models import resnet as tresnet
from medvill_torch.train import classify as tclf
from medvill_torch.train import optim as toptim
from medvill_tpu.core.config import (BertConfig, ClassificationConfig,
                                     ImageEncoderConfig)
from medvill_tpu.data.classification import (ClassificationDataset,
                                             synthetic_clf_records)
from medvill_tpu.data.pretrain import BatchLoader
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.train import classify as jclf
from medvill_tpu.train import optim as joptim
from medvill_tpu.train.pretrain import TrainState
from tests.torch_port_support import perturb, random_batch_stats
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

IMG = 64
VOCAB = 64
LABELS = ["'A'", "'B'", "'C'", "'D'"]
WORDS = [f"word{i}" for i in range(VOCAB - 5)]


def tokenizer():
    return BertTokenizer(build_vocab(WORDS))


def jax_cfg(encoder="full-fiber", n=4, flash=True, **kw):
    bert = dataclasses.replace(BertConfig.test_tiny(vocab_size=VOCAB),
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    image = ImageEncoderConfig(img_size=IMG, num_image_embeds=n,
                               encoder=encoder)
    return ClassificationConfig(bert=bert, image=image, num_image_embeds=n,
                                max_seq_len=n + 12, img_size=IMG,
                                batch_size=3, labels=tuple(LABELS),
                                use_flash_attention=flash, **kw)


def port_cfg(cfg) -> tcfg.ClassificationConfig:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(cfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(cfg.image))
    return tcfg.ClassificationConfig(**d)


def batches(cfg, n, seed=0, task_type="multilabel"):
    """``n`` numpy batches of 3 from the JAX dataset, random 64-px
    images."""
    recs = synthetic_clf_records(3 * n, LABELS, seed=seed)
    if task_type == "classification":
        for i, r in enumerate(recs):
            r["label"] = LABELS[i % len(LABELS)]
    rng = np.random.default_rng(seed)
    ds = ClassificationDataset(
        recs, tokenizer(), LABELS, cfg.max_seq_len,
        cfg.image.num_image_embeds, IMG, task_type=task_type,
        image_loader=lambda _: rng.integers(0, 256, (IMG, IMG, 3),
                                            dtype=np.uint8))
    return list(BatchLoader(ds, 3, shuffle=False))


@pytest.fixture(scope="module")
def base():
    """Perturbed weights and random BN statistics of the MMBT model (one
    JAX init for the module; the pool encoders have no parameters, so
    every configuration here shares them), the trunk perturbed less, as
    test_torch_port_pretrain.py's."""
    cfg = jax_cfg()
    model = jclf.build_model(cfg, len(LABELS))
    T = cfg.max_seq_len - cfg.image.num_image_embeds
    init = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((2, T), jnp.int32),
        jnp.ones((2,), jnp.int32), jnp.ones((2, T), jnp.int32),
        jnp.zeros((2, IMG, IMG, 3)), 2, 3))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = perturb(init["params"], rng, 0.05)
    params["enc"]["img_encoder"] = perturb(init["params"]["enc"]
                                           ["img_encoder"], rng, 0.02)
    return {"params": params,
            "batch_stats": random_batch_stats(init["batch_stats"], rng)}


def torch_model(cfg, v):
    pc = port_cfg(cfg)
    model = tclf.build_model(pc, len(LABELS))
    sd = mmbt_state_dict_from_flax(v["params"], v["batch_stats"])
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in sd.items()})
    return model, pc


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(a)) for k, a in batch.items()}


def ids():
    vocab = tokenizer().vocab
    return vocab["[CLS]"], vocab["[SEP]"]


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("side", [7, 8])
@pytest.mark.parametrize("n", sorted(jresnet.POOL_SHAPES))
def test_pooled_fibers_match_jax(n, side, mode):
    """torch's adaptive-pool segments against the JAX slices, on a 7x7
    (uneven segments) and an 8x8 map, within 1e-6."""
    fmap = np.random.default_rng(n * side).standard_normal(
        (2, side, side, 16)).astype(np.float32)
    want = np.asarray(jresnet.pooled_fibers(jnp.asarray(fmap), n, mode))
    got = tresnet.pooled_fibers(torch.from_numpy(fmap), n, mode)
    assert got.shape == (2, n, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("side", [7, 8])
def test_half_pooled_fibers_match_jax(side, mode):
    fmap = np.random.default_rng(side).standard_normal(
        (2, side, side, 16)).astype(np.float32)
    want = np.asarray(jresnet.half_pooled_fibers(jnp.asarray(fmap), mode))
    got = tresnet.half_pooled_fibers(torch.from_numpy(fmap), mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pool encoder"):
        tresnet.pooled_fibers(torch.from_numpy(fmap), 10)


ENCODERS = {"full-fiber": ("full-fiber", 4, "avg"),
            "pool-9": ("pool", 9, "avg"), "pool-3-max": ("pool", 3, "max"),
            "pool-half-max": ("pool-half", 1, "max")}


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_logits_match_jax(base, encoder):
    """Eval-mode logits (running BN statistics, no dropout) of the JAX eval
    step on the dense bias against the port's on the attention kernel path
    and on the dense bias, each within 1e-4 of their largest magnitude.
    (The JAX kernel path runs in test_loss_and_gradients_match_jax.)"""
    name, n, pool = ENCODERS[encoder]
    cfg = jax_cfg(name, n, flash=False)
    cfg = dataclasses.replace(cfg, image=dataclasses.replace(
        cfg.image, pool_type=pool))
    batch = batches(cfg, 1, seed=1)[0]
    model = jclf.build_model(cfg, len(LABELS))
    cls_id, sep_id = ids()
    eval_step = jax.jit(jclf.make_eval_step(model, cls_id, sep_id, cfg=cfg))
    state = TrainState(step=0, params=base["params"],
                       batch_stats=base["batch_stats"], opt_state=None)
    want = np.asarray(eval_step(state, jax.tree_util.tree_map(jnp.asarray,
                                                              batch)))
    scale = np.abs(want).max()
    assert scale > 0.1
    for flash in (True, False):
        tm, pc = torch_model(dataclasses.replace(
            cfg, use_flash_attention=flash), base)
        got = tclf.make_eval_step(pc, cls_id, sep_id)(tm, torch_batch(batch))
        assert got.dtype == torch.float32 and got.shape == (3, len(LABELS))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=str(flash))


def jax_loss(model, cfg, stats, batch, pw):
    """make_train_step's loss_fn (medvill_tpu/train/classify.py:98-125)."""
    from medvill_tpu.train.losses import weighted_bce_with_logits
    import optax

    attention_fn = (jclf._clf_flash_fn(cfg, batch)
                    if cfg.use_flash_attention else None)
    cls_id, sep_id = ids()

    def loss_fn(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": stats}, batch["input_txt"],
            batch["txt_len"], batch["segment"], batch["image"], cls_id,
            sep_id, deterministic=False, train_cnn=True,
            attention_fn=attention_fn, mutable=["batch_stats"])
        if cfg.task_type == "classification":
            loss = optax.softmax_cross_entropy_with_integer_labels(
                out, batch["label"]).mean()
        else:
            loss = weighted_bce_with_logits(out, batch["label"], pw)
        return loss, upd["batch_stats"]

    return loss_fn


def _jax_grads(base, cfg, batch, pw, dtype):
    """(loss, BN statistics after the forward, gradients in the MMBT
    layout as float64 numpy) of JAX's training forward, in ``dtype``."""
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype) if np.asarray(a).dtype.kind == "f"
        else jnp.asarray(a), t)
    model = jclf.build_model(cfg, len(LABELS))
    (loss, stats), g = jax.jit(jax.value_and_grad(jax_loss(
        model, cfg, cast(base["batch_stats"]), cast(batch),
        jnp.asarray(pw, dtype)), has_aux=True))(cast(base["params"]))
    g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g)
    return (float(loss), jax.tree_util.tree_map(np.asarray, stats),
            mmbt_state_dict_from_flax(g, base["batch_stats"]))


def _rel_rms(got: dict, want: dict, names) -> float:
    num = sum(((got[n] - want[n]) ** 2).sum() for n in names)
    return float(np.sqrt(num / sum((want[n] ** 2).sum() for n in names)))


def test_loss_and_gradients_match_jax(base):
    """The training forward with the trunk trained (train_cnn: batch
    statistics), weighted BCE, on the port's attention kernel path and on
    its dense bias, against JAX's kernel path (interpret mode): the loss
    within 1e-5 relative, BN statistics after the forward 1e-3, every
    gradient outside the trunk within 1e-3 of its tensor's largest entry
    (floor 1e-3), as test_torch_port_pretrain.py holds them.

    The trunk's 159 gradients cannot be held tensor by tensor in f32: a
    ReLU input within rounding of 0 takes the other branch under another
    summation order (JAX, the port, or the port at another thread count),
    and one such element moves a late-stage weight gradient by 25-48% of
    its tensor's scale, at 3 images of 64 px as at 8 of 128.  Here they
    are held to the same step computed by JAX in float64: the port's
    relative RMS error over the trunk, and its worst tensor's, at most
    twice JAX's own f32 figures.  test_trunk_gradients_match_jax_float64
    holds them tensor by tensor in float64, where both sides take the same
    branches."""
    cfg = jax_cfg(flash=True)
    batch = batches(cfg, 1, seed=2)[0]
    pw = np.array([3.0, 0.5, 2.0, 1.5], np.float32)
    want_loss, want_stats, want = _jax_grads(base, cfg, batch, pw,
                                             jnp.float32)
    with jax.enable_x64():
        c64 = dataclasses.replace(cfg, use_flash_attention=False,
                                  bert=dataclasses.replace(
                                      cfg.bert, compute_dtype="float64"))
        _, _, exact = _jax_grads(base, c64, batch, pw, jnp.float64)
    trunk = sorted(n for n in exact if n.startswith("enc.img_encoder.")
                   and not n.endswith(("running_mean", "running_var",
                                       "num_batches_tracked")))
    assert len(trunk) == 159  # 53 convolutions, 53 BatchNorms x 2
    jax_rms = _rel_rms(want, exact, trunk)
    jax_worst = max(_rel_rms(want, exact, [n]) for n in trunk)
    assert 0 < jax_rms < 0.2
    new_stats = mmbt_state_dict_from_flax(base["params"], want_stats)
    cls_id, sep_id = ids()
    for flash in (True, False):
        tm, pc = torch_model(dataclasses.replace(
            cfg, use_flash_attention=flash), base)
        loss, _ = tclf.loss_and_logits(tm, torch_batch(batch), None, pc,
                                       torch.from_numpy(pw), cls_id, sep_id)
        loss.backward()
        np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
        got = {n: p.grad.numpy().astype(np.float64)
               for n, p in tm.named_parameters()}
        for name, g in got.items():
            if name not in trunk:
                w = want[name]
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-3 * max(np.abs(w).max(), 1e-3),
                    err_msg=name)
        assert _rel_rms(got, exact, trunk) <= 2 * jax_rms
        assert max(_rel_rms(got, exact, [n]) for n in trunk) \
            <= 2 * jax_worst
        for k, t in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), new_stats[k],
                                           rtol=1e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("task_type,accum", [("multilabel", 1),
                                             ("classification", 2)],
                         ids=["weighted-bce", "softmax-ce-accum2"])
def test_three_bertadam_steps_match_jax(base, task_type, accum):
    """make_train_step + make_tx (clip, Adam without bias correction,
    masked decay, accumulation outermost, lr * warmup_linear(opt_step /
    t_total) applied in the step) against the port's BertAdam: 3 updates
    (3 * accum micro-steps, each on its own batch), lr 1e-3, t_total 4,
    warmup 0.1, so the lr scales are 0, 0.833, 0.556.  The trunk is in its
    frozen phase (freeze_img): its BatchNorm statistics still move, but its
    f32 gradients take other ReLU branches on the two sides (see
    test_loss_and_gradients_match_jax), and Adam turns those into other
    steps; test_trunk_three_bertadam_steps_match_jax_float64 steps the
    trained trunk in float64.  Every
    micro-step's loss within 1e-5 relative, every parameter within 5e-4
    (one update moves an entry by up to ~3e-3), BN statistics 1e-3, as
    test_torch_port_pretrain.py; every trainable tensor moved, the trunk's
    parameters not."""
    cfg = jax_cfg(lr=1e-3, gradient_accumulation_steps=accum,
                  task_type=task_type)
    data = batches(cfg, 3 * accum, seed=4, task_type=task_type)
    pw = (np.array([3.0, 0.5, 2.0, 1.5], np.float32)
          if task_type == "multilabel" else None)
    cls_id, sep_id = ids()
    model = jclf.build_model(cfg, len(LABELS))
    tx = jclf.make_tx(cfg, 4)
    state = TrainState(step=jnp.zeros([], jnp.int32), params=base["params"],
                       batch_stats=base["batch_stats"],
                       opt_state=tx.init(base["params"]))
    step = jax.jit(jclf.make_train_step(model, tx, cfg, 4, pw, cls_id,
                                        sep_id, freeze=(True, False)))
    want_losses = []
    for b in data:
        state, loss = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                           jax.random.PRNGKey(0), jnp.asarray(1.0))
        want_losses.append(float(loss))

    tm, pc = torch_model(cfg, base)
    ts = tclf.init_state(pc, len(LABELS), 4, device="cpu")
    ts.model.load_state_dict(tm.state_dict())
    tclf.apply_freeze(ts.model, True, False)
    train_step = tclf.make_train_step(
        pc, None if pw is None else torch.from_numpy(pw), cls_id, sep_id)
    gen = torch.Generator().manual_seed(0)
    losses = [train_step(ts, torch_batch(b), gen)["loss"].item()
              for b in data]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert ts.step == 3 * accum and ts.tx.optimizer.opt_step == 3
    want = mmbt_state_dict_from_flax(state.params, state.batch_stats)
    before = mmbt_state_dict_from_flax(base["params"], base["batch_stats"])
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
    # 2 layers x 16, embeddings 5, projection 2, pooler 2, clf 2
    assert moved == 2 * 16 + 11


def test_freeze_phases(base):
    """The freeze phases of make_train_step (mirroring
    tests/test_downstream.py::test_classification_freeze_phases): with the
    trunk and the text encoder frozen, 3 BertAdam updates leave every
    frozen tensor bit-unchanged with no Adam moments (and no weight decay)
    while the embeddings, projection, pooler and head train and the trunk's
    BatchNorm statistics move; then the same state steps unfrozen and the
    trunk and encoder train.  The decay groups hold every parameter, built
    once."""
    cfg = jax_cfg(lr=1e-3)
    data = batches(cfg, 4, seed=5)
    tm, pc = torch_model(cfg, base)
    ts = tclf.init_state(pc, len(LABELS), t_total=10, device="cpu")
    ts.model.load_state_dict(tm.state_dict())
    opt = ts.tx.optimizer
    params = dict(ts.model.named_parameters())
    assert sum(len(g["params"]) for g in opt.param_groups) == len(params)
    cls_id, sep_id = ids()
    step = tclf.make_train_step(pc, None, cls_id, sep_id)
    gen = torch.Generator().manual_seed(0)

    def frozen(name):
        return name.startswith(("enc.img_encoder.", "enc.encoder."))

    mask = tclf.freeze_mask(ts.model, True, True)
    assert {n for n, t in mask.items() if not t} == {n for n in params
                                                     if frozen(n)}
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    tclf.apply_freeze(ts.model, True, True)
    for b in data[:3]:
        assert np.isfinite(step(ts, torch_batch(b), gen)["loss"].item())
    after = {k: v.clone() for k, v in ts.model.state_dict().items()}
    for name, p in params.items():
        same = torch.equal(before[name], after[name])
        assert same == frozen(name), name
        if frozen(name):
            assert not opt.state[p] or not any(
                bool(v.any()) for v in opt.state[p].values()), name
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert all(not torch.equal(before[k], after[k]) for k in stats)
    tclf.apply_freeze(ts.model, False, False)
    step(ts, torch_batch(data[3]), gen)
    final = ts.model.state_dict()
    assert all(not torch.equal(after[n], final[n]) for n in params
               if frozen(n) and not n.endswith("key.bias"))


def _trunk_data(n, img, seed):
    """``n`` ImageNet-normalized float64 images (float inputs skip the
    trunks' uint8 normalization) and a float64 [n, img/32, img/32, 2048]
    weighting of the fiber map; the loss is the weighted sum."""
    from medvill_torch.data.images import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.default_rng(seed)
    pix = rng.integers(0, 256, (n, img, img, 3)) / 255.0
    x = (pix - IMAGENET_MEAN.astype(np.float64)) / IMAGENET_STD.astype(
        np.float64)
    return x, rng.standard_normal((n, img // 32, img // 32, 2048))


def _jax_trunk_step():
    """jit of (params, stats, x, r) -> ((loss, (fmap, new stats)), grads)
    of JAX's trunk in train mode, float64 (under jax.enable_x64)."""
    trunk = jresnet.ResNet50Trunk(dtype=jnp.float64)

    def loss_fn(params, stats, x, r):
        fmap, upd = trunk.apply({"params": params, "batch_stats": stats}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(fmap * r), (fmap, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _trunk_sd(params, stats) -> dict:
    """Flax trunk trees -> the port trunk's state dict, float64."""
    from medvill_torch.convert import _trunk

    sd: dict = {}
    _trunk(sd, "t", params, stats)
    return {k[2:]: np.asarray(v, np.float64) if np.asarray(v).dtype.kind
            == "f" else np.asarray(v) for k, v in sd.items()}


def _port_trunk(base):
    trunk = tresnet.ResNet50Trunk(dtype=torch.float64).double()
    sd = _trunk_sd(base["params"]["enc"]["img_encoder"],
                   base["batch_stats"]["enc"]["img_encoder"])
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return trunk


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("n,img", [(3, 64), (8, 128)], ids=["3x64", "8x128"])
def test_trunk_gradients_match_jax_float64(base, n, img):
    """The trained trunk alone (train-mode BatchNorm: batch statistics,
    running statistics updated) in float64 on both sides, against JAX's:
    the fiber map, every one of the 159 parameter gradients within 1e-8 of
    its tensor's largest entry, the running statistics after the forward
    within 1e-8 relative.  In float64 the two sides take the same ReLU
    branches, so the train-mode backward is compared tensor by tensor."""
    x, r = _trunk_data(n, img, seed=img + n)
    with jax.enable_x64():
        (_, (want_fmap, stats)), g = _jax_trunk_step()(
            _f64(base["params"]["enc"]["img_encoder"]),
            _f64(base["batch_stats"]["enc"]["img_encoder"]), x, r)
        want = _trunk_sd(g, stats)
        want_fmap = np.asarray(want_fmap)
    trunk = _port_trunk(base)
    fmap = trunk(torch.from_numpy(x), train=True)
    (fmap * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(fmap.detach().numpy(), want_fmap, rtol=0,
                               atol=1e-8 * np.abs(want_fmap).max())
    grads = {k: p.grad.numpy() for k, p in trunk.named_parameters()}
    assert len(grads) == 159  # 53 convolutions, 53 BatchNorms x 2
    for k, gk in grads.items():
        np.testing.assert_allclose(gk, want[k], rtol=0,
                                   atol=1e-8 * np.abs(want[k]).max(),
                                   err_msg=k)
    for k, t in trunk.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-8,
                                       atol=1e-12, err_msg=k)


def test_trunk_three_bertadam_steps_match_jax_float64(base):
    """Three steps of the trained trunk, float64 on both sides: JAX's
    make_tx (per-tensor clip, Adam without bias correction, decay masked
    off BatchNorm's scale and bias) with lr 1e-3 * warmup_linear(step / 4,
    0.1), as make_train_step applies it, against the port's BertAdam over
    decay_groups; each step on its own 3 images at 64 px.  Every parameter
    within 2e-6, under 1e-3 of the largest move of one step (lr * ~3.2):
    JAX's clip takes each tensor's norm in f32, which moves the second
    update by ~1e-9, and the train-mode net turns that into ~5e-6 of the
    third step's gradients.  Running statistics within 1e-6 of their
    tensor's largest entry; all
    159 parameters moved."""
    cfg = jax_cfg(lr=1e-3)
    data = [_trunk_data(3, IMG, seed=20 + i) for i in range(3)]
    with jax.enable_x64():
        params = _f64(base["params"]["enc"]["img_encoder"])
        stats = _f64(base["batch_stats"]["enc"]["img_encoder"])
        step = _jax_trunk_step()
        tx = jclf.make_tx(cfg, 4)
        opt = tx.init(params)
        for i, (x, r) in enumerate(data):
            (_, (_, stats)), g = step(params, stats, x, r)
            updates, opt = tx.update(g, opt, params)
            lr_t = cfg.lr * float(joptim.warmup_linear(i / 4, cfg.warmup))
            params = jax.tree_util.tree_map(lambda p, u: p - lr_t * u,
                                            params, updates)
        want = _trunk_sd(params, stats)
    trunk = _port_trunk(base)
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    opt = toptim.BertAdam(toptim.decay_groups(trunk, 0.01), cfg.lr, 4,
                          warmup=cfg.warmup, weight_decay=0.01)
    for x, r in data:
        opt.zero_grad()
        (trunk(torch.from_numpy(x), train=True)
         * torch.from_numpy(r)).sum().backward()
        opt.step()
    moved = 0
    for k, t in trunk.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=0,
                                       atol=1e-6 * np.abs(want[k]).max(),
                                       err_msg=k)
            continue
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=2e-6,
                                   err_msg=k)
        moved += not torch.equal(t, before[k])
    assert moved == 159
