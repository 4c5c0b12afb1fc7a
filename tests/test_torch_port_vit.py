"""The port's ViT image encoder (``--img_encoder ViT``) against the JAX
package's on the same numpy inputs and the same weights (the flax tree
carried through cxrbert_state_dict_from_flax, which keeps the patch
embedding that JAX's own export drops): the patch features, the pretrain
loss, metrics and every gradient, three AdamW steps; the patch weights
through model.<N>.bin and optim.<N>.bin; the pretrain CLI under ViT.
The configuration is tests/test_vit_and_loader.py's: 64-px images, patch
32, 4 image tokens, the test-tiny BERT.  Dropout is 0: the two packages
draw different dropout bits."""
import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import checkpoint as ckpt
from medvill_torch import torch_init
from medvill_torch.cli import pretrain_main
from medvill_torch.convert import (_read_checkpoint,
                                   cxrbert_state_dict_from_flax,
                                   load_cxrbert_checkpoint)
from medvill_torch.data import pretrain as tdata
from medvill_torch.models import joint as tjoint
from medvill_torch.models.resnet import ResNet50Trunk
from medvill_torch.train import pretrain as tpre
from medvill_torch.train.dispatch import MultiStep
from medvill_tpu.core.config import (BertConfig, ImageEncoderConfig,
                                     PretrainConfig)
from medvill_tpu.models import joint as jjoint
from medvill_tpu.models.cxrbert import CXRBERT as JaxCXRBERT
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import pretrain as jpre
from tests.test_torch_port_pretrain import (batches, port_cfg, torch_batch,
                                            torch_model)
from tests.torch_port_support import perturb

IMG, PATCH, N_IMG, VOCAB = 64, 32, 4, 64
PATCH_KEYS = ("enc.img_encoder.patch_to_embedding.weight",
              "enc.img_encoder.patch_to_embedding.bias")
WORDS = [f"word{i}" for i in range(50)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CLI run here takes the same time on one intra-op thread and
    half the CPU time of the default, which the other test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vit_cfg(**kw) -> PretrainConfig:
    bert = dataclasses.replace(BertConfig.test_tiny(vocab_size=VOCAB),
                               hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    image = ImageEncoderConfig(encoder="ViT", img_size=IMG, patch_size=PATCH,
                               num_image_embeds=N_IMG, img_hidden_size=32)
    return PretrainConfig(seq_len=7, bert=bert, image=image, batch_size=3,
                          **kw)


def vit_variables(cfg, seed=0):
    """(model, perturbed params): a ViT model has no BatchNorm, so no
    batch statistics."""
    model = jpre.build_model(cfg)
    L_txt, B = cfg.seq_len + 1, 2
    variables = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((B, 1), jnp.int32),
        jnp.zeros((B, L_txt), jnp.int32), jnp.zeros((B, 2), jnp.int32),
        jnp.ones((B, L_txt), jnp.int32), jnp.zeros((B, IMG, IMG, 3)),
        jnp.zeros((B, 1), jnp.int32)))(jax.random.PRNGKey(seed))
    assert not variables.get("batch_stats")
    assert set(variables["params"]["enc"]["img_encoder"]) == {
        "patch_to_embedding"}
    return model, perturb(variables["params"], np.random.default_rng(seed),
                          0.05)


def _images(seed=0, n=3):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3),
                                                dtype=np.uint8)


def _nchw_patches(img: torch.Tensor, p: int) -> torch.Tensor:
    """The flattening a port that forgot the NHWC layout would give:
    (channel, row in patch, column in patch) per patch."""
    x = tjoint.device_normalize(img).permute(0, 3, 1, 2)
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def test_patch_features_match_jax_and_catch_a_permuted_flattening():
    """uint8 NHWC images -> [B, 4, 32] patch features within 1e-5 of JAX's
    ImagePatchEmbedding.  The same weights applied to an NCHW flattening
    land far outside that tolerance, so the test sees the order."""
    img = _images(1)
    emb = jjoint.ImagePatchEmbedding(image_size=IMG, patch_size=PATCH, dim=32)
    v = jax.jit(emb.init)({"params": jax.random.PRNGKey(1)},
                          jnp.asarray(img))
    want = np.asarray(jax.jit(emb.apply)(v, jnp.asarray(img)))
    port = tjoint.ImagePatchEmbedding(PATCH, 32)
    lin = v["params"]["patch_to_embedding"]
    port.load_state_dict({
        "patch_to_embedding.weight": torch.from_numpy(
            np.array(lin["kernel"]).T),
        "patch_to_embedding.bias": torch.from_numpy(np.array(lin["bias"]))})
    t_img = torch.from_numpy(img)
    with torch.no_grad():
        got = port(t_img).numpy()
        permuted = port.patch_to_embedding(_nchw_patches(t_img, PATCH))
    assert got.shape == want.shape == (3, N_IMG, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(permuted.numpy() - want).max() > 100 * 1e-5


def test_features_loss_and_gradients_match_jax():
    """Train-mode step of the JAX test's configuration: the image tokens'
    features (positions 1..4 of the sequence) and the pooled output within
    1e-4; the loss and metrics within 1e-5; every gradient, the patch
    embedding's included, within 1e-4 of its tensor's largest entry (floor
    1e-6 for the key biases, whose exact gradient is zero).  No trunk, so
    no BatchNorm spread as in the ResNet tests: both sides are f32 GEMMs
    on identical inputs."""
    cfg = vit_cfg(mlm_gather_bound=4)
    model, params = vit_variables(cfg, seed=3)
    batch = batches(cfg, 1, seed=3)[0]
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        return jpre.pretrain_loss_and_metrics(
            model, p, {}, jb, jax.random.PRNGKey(0), None, cfg, train=True)

    (_, (want_m, _)), want_g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    args = [jb[k] for k in ("cls_tok", "input_txt", "mask_spec", "segment",
                            "image", "sep_tok")]
    want_seq, want_pooled = jax.jit(lambda p: model.apply(
        {"params": p}, *args, method=JaxCXRBERT.features))(params)

    tm = torch_model(cfg, params, {})
    tb = torch_batch(batch)
    with torch.no_grad():
        seq, pooled = tm.features(*(tb[k] for k in (
            "cls_tok", "input_txt", "mask_spec", "segment", "image",
            "sep_tok")))
    np.testing.assert_allclose(seq[:, 1:N_IMG + 1].numpy(),
                               np.asarray(want_seq)[:, 1:N_IMG + 1],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               rtol=1e-4, atol=1e-4)
    loss, got_m = tpre.pretrain_loss_and_metrics(tm, tb, None, None,
                                                 port_cfg(cfg), train=True)
    loss.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].detach().numpy(),
                                   np.asarray(want_m[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    grads = cxrbert_state_dict_from_flax(want_g, {})
    names = []
    for name, p in tm.named_parameters():
        assert p.requires_grad, name    # nothing is frozen under ViT
        w = grads[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-2),
                                   err_msg=name)
        names.append(name)
    assert set(PATCH_KEYS) <= set(names)
    assert np.abs(grads[PATCH_KEYS[0]]).max() > 0
    # 2 layers x 16; embeddings 5, patch 2, projection 2, pooler 2, MLM 5,
    # ITM 2
    assert len(names) == 2 * 16 + 18


@pytest.mark.parametrize("accum", [1, 2])
def test_three_adamw_steps_match_jax(accum):
    """The JAX CLI's optimizer under ViT (accumulate(adamw), no freeze
    mask: medvill_tpu/cli/pretrain_main.py:223) against the port's, lr
    1e-3 so the parameters move: every parameter after 3 micro-steps
    within 2e-5, where one Adam step moves an entry by up to 1e-3, and
    every tensor moved, the patch embedding too."""
    cfg = vit_cfg(lr=1e-3, gradient_accumulation_steps=accum)
    model, params = vit_variables(cfg, seed=4)
    tx = joptim.accumulate(joptim.adamw(cfg.lr, cfg.beta1, cfg.beta2,
                                        cfg.eps, cfg.weight_decay), accum)
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                            batch_stats={}, opt_state=tx.init(params))
    step = jax.jit(jpre.make_train_step(model, tx, cfg))
    data = batches(cfg, 3, seed=4)
    for b in data:
        state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))

    pc = port_cfg(cfg)
    ts = tpre.init_state(pc, device="cpu")
    ts.model.load_state_dict(torch_model(cfg, params, {}).state_dict())
    assert tpre.pixel_draw(pc) is None
    train_step = tpre.make_train_step(pc)
    gen = torch.Generator().manual_seed(0)
    for b in data:
        train_step(ts, torch_batch(b), gen)
    assert ts.step == 3 and ts.tx.count == 3 % accum
    want = cxrbert_state_dict_from_flax(state.params, {})
    before = cxrbert_state_dict_from_flax(params, {})
    moved = []
    for k, v in ts.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
        if not np.array_equal(v.numpy(), before[k]):
            moved.append(k)
    assert set(PATCH_KEYS) <= set(moved)
    assert len(moved) == len(ts.model.state_dict())


def test_patch_weights_round_trip_model_and_optim_files(tmp_path):
    """Two k = 2 dispatches, saved as model.0.bin + optim.0.bin, restored
    into a fresh state: the patch weights and their Adam moments come back
    equal, the model file loads strictly and carries the patch keys, and
    the next micro-step from the restored state equals the one from the
    state that was saved."""
    pc = port_cfg(vit_cfg(lr=1e-3, gradient_accumulation_steps=2))
    data = batches(vit_cfg(), 5, seed=5)
    loader = tdata.BatchLoader([], 3, shuffle=False)
    gen = torch.Generator().manual_seed(0)
    state = tpre.init_state(pc, seed=1, device="cpu")
    step = tpre.make_train_step(pc)
    multi = MultiStep(step, 2)
    for i in (0, 2):
        group = {k: torch.stack([torch.from_numpy(np.asarray(b[k]))
                                 for b in data[i:i + 2]])
                 for k in data[0]}
        multi(state, group, gen)
    ckpt.save_training_state(str(tmp_path), 0, state, gen, loader, False)
    assert set(PATCH_KEYS) <= set(_read_checkpoint(
        str(tmp_path / "model.0.bin")))
    fresh = tpre.init_state(pc, seed=2, device="cpu")
    assert load_cxrbert_checkpoint(fresh.model,
                                   str(tmp_path / "model.0.bin")) == []
    gen2 = torch.Generator()
    fresh = tpre.init_state(pc, seed=2, device="cpu")
    ckpt.restore_training_state(str(tmp_path), 0, fresh, gen2)
    for k in PATCH_KEYS:
        torch.testing.assert_close(fresh.model.state_dict()[k],
                                   state.model.state_dict()[k], rtol=0,
                                   atol=0)
    assert fresh.tx.state_dict().keys() == state.tx.state_dict().keys()
    last = torch_batch(data[4])
    m_saved = step(state, last, gen)
    m_restored = step(fresh, torch_batch(data[4]), gen2)
    torch.testing.assert_close(m_restored["loss"], m_saved["loss"], rtol=0,
                               atol=0)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)


def test_encoder_refuses_a_token_count_the_patches_do_not_give():
    pc = port_cfg(vit_cfg())
    image = dataclasses.replace(pc.image, num_image_embeds=3)
    with pytest.raises(ValueError, match="4 image tokens"):
        tjoint.JointEncoder(pc.bert, image)


def _write_dataset(d: str, n: int = 4):
    from PIL import Image

    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS) + "\n")
    rng = np.random.default_rng(0)
    recs = tdata.synthetic_records(n, random.Random(1), words=WORDS)
    for r in recs:
        Image.fromarray(rng.integers(0, 256, (IMG, IMG), np.uint8),
                        "L").save(os.path.join(d, r["img"]), format="PNG")
    data = os.path.join(d, "train.jsonl")
    with open(data, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return data, vocab


def test_pretrain_cli_trains_vit_without_a_trunk_warning(tmp_path, caplog):
    """``--img_encoder ViT`` at 64 px (patch 32, 4 tokens): finite losses,
    no frozen-trunk warning, a model.0.bin carrying the patch weights and
    loading strictly, and a relaunch with ``--weight_load`` from the run
    directory restores them; ``--resnet_init_path`` raises under ViT, as
    JAX's shape check does (medvill_tpu/core/torch_init.py:95)."""
    data, vocab = _write_dataset(str(tmp_path))
    out = str(tmp_path / "run")
    argv = ["--train_dataset", data, "--vocab_file", vocab,
            "--output_path", out, "--bert_model", "test-tiny",
            "--vocab_size", "64", "--img_size", str(IMG),
            "--num_image_embeds", str(N_IMG), "--img_hidden_sz", "32",
            "--img_encoder", "ViT", "--seq_len", "12", "--batch_size", "2",
            "--epochs", "1", "--num_workers", "1", "--lr", "1e-3",
            "--device", "cpu"]
    with caplog.at_level("INFO", logger="medvill_torch"):
        rows = pretrain_main.main(argv)
    assert len(rows) == 1 and np.isfinite(rows[0]["avg_loss"])
    assert "randomly initialized" not in caplog.text
    assert "WARNING" not in caplog.text
    cfg = pretrain_main.config_from_args(
        pretrain_main.build_parser().parse_args(argv))
    assert cfg.image.encoder == "ViT" and cfg.image.patch_size == 32
    model = tpre.build_model(cfg)
    path = os.path.join(out, "model.0.bin")
    assert load_cxrbert_checkpoint(model, path) == []
    saved = _read_checkpoint(path)
    for k in PATCH_KEYS:
        torch.testing.assert_close(model.state_dict()[k], saved[k])
    assert saved[PATCH_KEYS[0]].shape == (32, PATCH * PATCH * 3)
    state = tpre.init_state(cfg, device="cpu")
    gen = torch.Generator()
    pretrain_main._initialize(pretrain_main.build_parser().parse_args(
        argv + ["--weight_load", "true", "--pre_trained_model_path", out]),
        cfg, state, gen, pretrain_main.create_logger(
            str(tmp_path / "relaunch.log"), None))
    torch.testing.assert_close(state.model.state_dict()[PATCH_KEYS[0]],
                               saved[PATCH_KEYS[0]], rtol=0, atol=0)
    trunk = ResNet50Trunk(dtype=torch.float32).state_dict()
    tv = torch_init._sequential_trunk_sd(
        {f"t.{k}": v for k, v in trunk.items()}, "t")
    assert "conv1.weight" in tv
    with pytest.raises(ValueError):
        torch_init.init_resnet_from_torch(state.model, tv)
