"""The port's pretraining step against the JAX package's on the same numpy
inputs and the same weights (carried through cxrbert_state_dict_from_flax):
the ResNet trunk's train-mode BatchNorm, CXRBERT's features and heads, the
loss, metrics and gradients of pretrain_loss_and_metrics (attention kernel
path and dense-bias path; the JAX side runs its Pallas kernel in interpret
mode), and the parameters and BatchNorm statistics after three AdamW steps
with gradient accumulation 1 and 2.  Dropout is 0: the two packages draw
different dropout bits (the port's dropout has its own tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import _trunk, cxrbert_state_dict_from_flax
from medvill_torch.models import resnet as tresnet
from medvill_torch.models.cxrbert import CXRBERT as TorchCXRBERT
from medvill_torch.train import pretrain as tpre
from medvill_tpu.core.config import (BertConfig, ImageEncoderConfig,
                                     MaskVariant, PretrainConfig)
from medvill_tpu.data.pretrain import (BatchLoader, CXRPretrainDataset,
                                       synthetic_records)
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.models.cxrbert import CXRBERT as JaxCXRBERT
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import pretrain as jpre
from tests.torch_port_support import (perturb, random_batch_stats,
                                      sub_state_dict)
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

IMG = 64
VOCAB = 64


def jax_cfg(encoder="random-pixel", num_image_embeds=3, **kw):
    bert = dataclasses.replace(BertConfig.test_tiny(vocab_size=VOCAB),
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    image = ImageEncoderConfig(img_size=IMG, num_image_embeds=num_image_embeds,
                               img_hidden_size=64, encoder=encoder)
    return PretrainConfig(seq_len=7, bert=bert, image=image, batch_size=3,
                          **kw)


def port_cfg(cfg: PretrainConfig) -> tcfg.PretrainConfig:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(cfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(cfg.image))
    return tcfg.PretrainConfig(**d)


def batches(cfg, n, seed=0):
    vocab = build_vocab([f"word{i}" for i in range(50)])
    rng = np.random.default_rng(seed)
    ds = CXRPretrainDataset(
        synthetic_records(cfg.batch_size * n), BertTokenizer(vocab), cfg,
        seed=seed, image_loader=lambda _: rng.integers(
            0, 256, (IMG, IMG, 3), dtype=np.uint8))
    return list(BatchLoader(ds, cfg.batch_size, shuffle=False))


def jax_variables(cfg, seed=0):
    """Perturbed params and random BN statistics, so every path matters.
    Built without the NONCROSS layout, so the pooler exists for every
    variant."""
    model = jpre.build_model(cfg)
    L_txt = cfg.seq_len + 1
    B = 2
    variables = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((B, 1), jnp.int32),
        jnp.zeros((B, L_txt), jnp.int32), jnp.zeros((B, 2), jnp.int32),
        jnp.ones((B, L_txt), jnp.int32), jnp.zeros((B, IMG, IMG, 3)),
        jnp.zeros((B, 1), jnp.int32),
        pixel_indices=jnp.arange(cfg.image.num_image_embeds)))(
            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    init = variables["params"]
    params = perturb(init, rng, 0.05)
    params["enc"]["img_encoder"] = perturb(init["enc"]["img_encoder"], rng,
                                           0.02)
    return model, params, random_batch_stats(variables["batch_stats"], rng)


def torch_model(cfg, params, batch_stats) -> TorchCXRBERT:
    pc = port_cfg(cfg)
    model = TorchCXRBERT(pc.bert, pc.image, img_position=cfg.img_position)
    sd = cxrbert_state_dict_from_flax(params, batch_stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()})
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_resnet_train_mode_batchnorm_matches_flax():
    """Batch statistics in the forward, running statistics moved with the
    biased batch variance at momentum 0.9 (torch's training-mode batch_norm
    would use the unbiased one: 14% apart at this size).  Tolerance 2e-3 of
    the output scale: at batch 2 the last stages normalize 8 values per
    channel through E[x^2] - E[x]^2, and both f32 runs sit 2.5e-3 (port)
    and 5.3e-3 (JAX) of a 7.1 maximum from a float64 run of the port."""
    img = np.random.default_rng(1).integers(0, 256, (2, IMG, IMG, 3),
                                            dtype=np.uint8)
    trunk = jresnet.ResNet50Trunk(dtype=jnp.float32)
    v = jax.jit(trunk.init)({"params": jax.random.PRNGKey(1)},
                            jnp.asarray(img))
    rng = np.random.default_rng(1)
    params = perturb(v["params"], rng, 0.02)
    stats = random_batch_stats(v["batch_stats"], rng)
    want, upd = jax.jit(lambda p, s, x: trunk.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, jnp.asarray(img))
    sd = {}
    _trunk(sd, "t", params, stats)
    tt = tresnet.ResNet50Trunk(dtype=torch.float32)
    tt.load_state_dict(sub_state_dict(sd, "t."))
    with torch.no_grad():
        got = tt(torch.from_numpy(img), train=True)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * scale)
    new_sd = {}
    _trunk(new_sd, "t", params, upd["batch_stats"])
    own = tt.state_dict()
    stat_keys = [k for k in own if k.endswith(("running_mean",
                                               "running_var"))]
    assert len(stat_keys) == 2 * 53
    for k in stat_keys:
        w = new_sd["t." + k]
        np.testing.assert_allclose(own[k].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("variant", [MaskVariant.BAR, MaskVariant.NONCROSS],
                         ids=lambda v: v.name)
def test_features_and_heads_match_jax(variant):
    """Eval-mode forward (running BN statistics): sequence, pooled (or the
    NONCROSS CLS product), MLM and ITM logits."""
    cfg = jax_cfg(disturbing_mask=variant == MaskVariant.NONCROSS,
                  bar_attn=variant == MaskVariant.BAR)
    model, params, stats = jax_variables(cfg, seed=2)
    batch = batches(cfg, 1, seed=2)[0]
    assert (batch["mask_spec"][:, 0] == int(variant)).all()
    pix = np.array([0, 2, 3], np.int32)
    args = [jnp.asarray(batch[k]) for k in ("cls_tok", "input_txt",
                                            "mask_spec", "segment", "image",
                                            "sep_tok")]
    kw = dict(pixel_indices=jnp.asarray(pix),
              disturbing=cfg.disturbing_mask)
    v = {"params": params, "batch_stats": stats}

    def fwd(v, *args):
        seq, pooled = model.apply(v, *args, method=JaxCXRBERT.features, **kw)
        return (seq, pooled,
                model.apply(v, seq[:, -4:], method=JaxCXRBERT.mlm_chunk),
                model.apply(v, pooled, method=JaxCXRBERT.itm_logits))

    want = jax.jit(fwd)(v, *args)
    tm = torch_model(cfg, params, stats)
    tb = torch_batch(batch)
    with torch.no_grad():
        seq, pooled = tm.features(
            tb["cls_tok"], tb["input_txt"], tb["mask_spec"], tb["segment"],
            tb["image"], tb["sep_tok"], pixel_indices=torch.tensor(pix),
            disturbing=cfg.disturbing_mask)
        got = (seq, pooled, tm.mlm_chunk(seq[:, -4:]), tm.itm_logits(pooled))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _jax_pixel_indices(cfg, seed, step):
    """The JAX train step's draw (pretrain.py:239-243), made on the test
    side: jax.random cannot be reproduced in torch."""
    step_rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    pix_rng, _ = jax.random.split(step_rng)
    return np.asarray(jpre.sample_pixel_indices(
        pix_rng, cfg.image.num_fibers, cfg.image.num_image_embeds))


@pytest.mark.parametrize("flash", [True, False],
                         ids=["attention-kernel", "dense-bias"])
def test_loss_metrics_and_gradients_match_jax(flash):
    """Loss and metrics 1e-5.  Every trainable gradient within 1e-3 of the
    largest entry of its tensor (floor 1e-6, for the key biases, whose
    gradient is zero up to rounding): the image features come out of the
    train-mode trunk, 2e-3 of scale apart between the two packages (see the
    BatchNorm test above), and the gradients inherit it (3.7e-4 measured,
    the same with and without the attention kernel).  BN statistics after
    the train-mode forward: 1e-3."""
    cfg = jax_cfg(use_flash_attention=flash, mlm_gather_bound=4)
    model, params, stats = jax_variables(cfg, seed=3)
    batch = batches(cfg, 1, seed=3)[0]
    pix = _jax_pixel_indices(cfg, seed=5, step=0)

    def loss_fn(p):
        return jpre.pretrain_loss_and_metrics(
            model, p, stats, jax.tree_util.tree_map(jnp.asarray, batch),
            jax.random.PRNGKey(0), jnp.asarray(pix), cfg, train=True)

    (_, (want_m, want_stats)), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    tm = torch_model(cfg, params, stats)
    loss, got_m = tpre.pretrain_loss_and_metrics(
        tm, torch_batch(batch), None, torch.tensor(pix).long(),
        port_cfg(cfg), train=True)
    loss.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].detach().numpy(),
                                   np.asarray(want_m[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    grads = cxrbert_state_dict_from_flax(want_g, stats)
    n = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None
            continue
        w = grads[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)
        n += 1
    # 2 layers x 16; embeddings 5, projection 2, pooler 2, MLM 5, ITM 2
    assert n == 2 * 16 + 16
    new_stats = cxrbert_state_dict_from_flax(params, want_stats)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new_stats[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_adamw_steps_match_jax(accum):
    """The JAX CLI's optimizer (masked whole-trunk freeze around
    accumulate(adamw)) against the port's, lr 1e-3 so the parameters move:
    every parameter and BN statistic after 3 micro-steps, the 48 trainable
    tensors moved and the frozen trunk not.  Full-fiber encoder, so neither
    side draws pixel indices.  Parameters within 5e-4, where one Adam step
    moves an entry by up to 1e-3: the worst (3.9e-4) is the image
    projection, whose gradient multiplies the train-mode trunk's features
    (2e-3 of scale apart, see the BatchNorm test); BN statistics 1e-3."""
    cfg = jax_cfg(encoder="full-fiber", num_image_embeds=4, lr=1e-3,
                  gradient_accumulation_steps=accum)
    model, params, stats = jax_variables(cfg, seed=4)
    tx = joptim.masked_trainable(
        joptim.accumulate(joptim.adamw(cfg.lr, cfg.beta1, cfg.beta2,
                                       cfg.eps, cfg.weight_decay), accum),
        lambda p: jresnet.cnn_freeze_mask(p, ("enc", "img_encoder")))
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                            batch_stats=stats, opt_state=tx.init(params))
    step = jax.jit(jpre.make_train_step(model, tx, cfg))
    data = batches(cfg, 3, seed=4)
    for b in data:
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))

    pc = port_cfg(cfg)
    ts = tpre.init_state(pc, device="cpu")
    ts.model.load_state_dict(torch_model(cfg, params, stats).state_dict())
    train_step = tpre.make_train_step(pc)
    gen = torch.Generator().manual_seed(0)
    for b in data:
        train_step(ts, torch_batch(b), gen)
    assert ts.step == 3 and ts.tx.count == 3 % accum
    want = cxrbert_state_dict_from_flax(state.params, state.batch_stats)
    before = cxrbert_state_dict_from_flax(params, stats)
    moved = 0
    for k, v in ts.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)
            continue
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=5e-4,
                                   err_msg=k)
        moved += not np.array_equal(v.numpy(), before[k])
    assert moved == 48 + 1  # the tied decoder weight is listed twice
