"""Resume, preemption and the pretrain eval of the port against the JAX
package: ``BatchLoader.skip_next`` (the pretrain, finetune and VQA
datasets, one shared stream and per-sample RNGs) yields JAX's tail byte
for byte; the two packages read each other's preemption marker;
``make_eval_step`` and ``watch_norms`` equal JAX's on converted weights
and equal optimizer states.  The CLIs' resume runs are in
test_torch_port_resume_cli.py."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import config as tcfg
from medvill_torch.convert import cxrbert_state_dict_from_flax
from medvill_torch.data import pretrain as tdata
from medvill_torch.data import seq2seq as tseq
from medvill_torch.data import vqa as tvqa
from medvill_torch.data.tokenization import BertTokenizer as TTokenizer
from medvill_torch.train import optim as toptim
from medvill_torch.train import pretrain as tpre
from medvill_torch.utils import preempt as tpreempt
from medvill_torch.utils.logging import watch_norms
from medvill_tpu.core.config import BertConfig, FinetuneConfig
from medvill_tpu.data import pretrain as jdata
from medvill_tpu.data import seq2seq as jseq
from medvill_tpu.data import vqa as jvqa
from medvill_tpu.data.tokenization import BertTokenizer, build_vocab
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import pretrain as jpre
from medvill_tpu.utils import logging as jlogging
from medvill_tpu.utils import preempt as jpreempt
from tests.test_torch_port_pretrain import (batches, jax_cfg, jax_variables,
                                            port_cfg, torch_batch,
                                            torch_model)

WORDS = [f"word{i}" for i in range(50)]


def _image(path):
    """A deterministic 8-px image per path, the same for both packages."""
    seed = sum(map(ord, path))
    return np.random.default_rng(seed).integers(0, 256, (8, 8, 3),
                                                dtype=np.uint8)


def _datasets(kind: str):
    """(JAX dataset, port dataset) over the same records and seed."""
    vocab = build_vocab(WORDS)
    if kind == "pretrain":
        jcfg = jax_cfg()
        recs = jdata.synthetic_records(20, random.Random(3), words=WORDS)
        return (jdata.CXRPretrainDataset(recs, BertTokenizer(vocab), jcfg,
                                         seed=5, image_loader=_image),
                tdata.CXRPretrainDataset(recs, TTokenizer(vocab),
                                         port_cfg(jcfg), seed=5,
                                         image_loader=_image))
    jcfg = FinetuneConfig(bert=BertConfig.test_tiny(vocab_size=64),
                          max_seq_length=24, len_vis_input=3, img_size=8,
                          max_pred=3, s2s_prob=0.5, bi_prob=0.5)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
         if f.name != "mesh_shape"}
    d["bert"] = tcfg.BertConfig(**dataclasses.asdict(jcfg.bert))
    d["image"] = tcfg.ImageEncoderConfig(**dataclasses.asdict(jcfg.image))
    pcfg = tcfg.FinetuneConfig(**d)
    if kind == "finetune":
        recs = [dict(text=" ".join(random.Random(i).choices(WORDS, k=6)),
                     img=f"img{i}.png") for i in range(20)]
        return (jseq.Img2TxtDataset(recs, BertTokenizer(vocab), jcfg, seed=9,
                                    image_loader=_image),
                tseq.Img2TxtDataset(recs, TTokenizer(vocab), pcfg, seed=9,
                                    image_loader=_image))
    entries = jvqa.synthetic_vqa_entries(20, num_answers=jcfg.vqa_num_answers,
                                         seed=4)
    return (jvqa.VQADataset(jcfg, BertTokenizer(vocab), entries, seed=9,
                            image_loader=_image),
            tvqa.VQADataset(pcfg, TTokenizer(vocab), entries, seed=9,
                            image_loader=_image))


@pytest.mark.parametrize("kind,workers", [
    ("pretrain", 1), ("pretrain", 2), ("finetune", 1), ("finetune", 2),
    ("vqa", 1)])
def test_skip_next_tail_matches_jax(kind, workers):
    """After a full epoch, ``skip_next(2)`` of 5 batches: the port's three
    tail batches equal JAX's byte for byte and its own unskipped epoch's
    (workers 1: the skipped draws replayed through ``fetch(idx,
    load_image=False)``), the skip acts once, and a replay fetch returns
    None."""
    def loader(ds, package):
        return package.BatchLoader(ds, 4, shuffle=True, seed=7,
                                   workers=workers)

    jds, tds = _datasets(kind)
    jl, tl = loader(jds, jdata), loader(tds, tdata)
    _, whole = _datasets(kind)
    wl = loader(whole, tdata)
    try:
        for it in (jl, tl, wl):
            list(it)  # epoch 0 moves the shared stream and the order
        jl.skip_next(2)
        tl.skip_next(2)
        want, got, full = list(jl), list(tl), list(wl)
        assert len(got) == len(want) == 3 and len(full) == 5
        for j, t, f in zip(want, got, full[2:]):
            assert j.keys() == t.keys() == f.keys()
            for k in j:
                assert t[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
                np.testing.assert_array_equal(t[k], f[k], err_msg=k)
        assert len(list(tl)) == 5  # once only
    finally:
        tl.close()
        wl.close()
    assert tds.fetch(0, load_image=False) is None


def test_preemption_marker_is_shared_with_jax(tmp_path):
    jpreempt.write_marker(str(tmp_path), epoch=3, batches_done=17)
    assert tpreempt.read_marker(str(tmp_path)) == {"epoch": 3,
                                                   "batches_done": 17}
    tpreempt.clear_marker(str(tmp_path))
    assert jpreempt.read_marker(str(tmp_path)) is None
    tpreempt.write_marker(str(tmp_path), epoch=1, batches_done=4)
    assert jpreempt.read_marker(str(tmp_path)) == {"epoch": 1,
                                                   "batches_done": 4}


@pytest.fixture(scope="module")
def pretrained():
    """A JAX config (dense attention, dropout 0, random-pixel), its
    perturbed weights, the port model on them and one batch."""
    cfg = dataclasses.replace(jax_cfg(), use_flash_attention=False)
    model, params, stats = jax_variables(cfg, seed=6)
    return cfg, model, params, stats, batches(cfg, 1, seed=6)[0]


def test_eval_step_matches_jax(pretrained):
    """JAX's ``make_eval_step`` (its dense-bias path) against the port's
    (the attention kernel's plain version on the CPU) on converted weights,
    the pixel indices of JAX's fixed ``PRNGKey(0)`` draw handed to the
    port: the same metric keys, f32 within 1e-5 relative, the counts
    equal; and the port's own fixed draw is a sorted subset of the
    fibers, the same at every call."""
    cfg, model, params, stats, batch = pretrained
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                            batch_stats=stats, opt_state=None)
    want = jax.jit(jpre.make_eval_step(model, cfg))(
        state, jax.tree_util.tree_map(jnp.asarray, batch))
    pix = jpre.sample_pixel_indices(jax.random.PRNGKey(0),
                                    cfg.image.num_fibers,
                                    cfg.image.num_image_embeds)
    pc = dataclasses.replace(port_cfg(cfg), use_flash_attention=True)
    tm = torch_model(cfg, params, stats)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    got = tpre.make_eval_step(pc, torch.tensor(np.asarray(pix)).long())(
        tm, torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=0, err_msg=k)
    for k, v in tm.state_dict().items():  # eval moves no statistic
        assert torch.equal(v, before[k]), k
    own = tpre.eval_pixel_indices(pc)
    assert torch.equal(own, tpre.eval_pixel_indices(pc))
    assert own.shape == (cfg.image.num_image_embeds,)
    assert (own.diff() > 0).all() and own.max() < cfg.image.num_fibers


def _norms_float64(state) -> dict:
    """JAX's ``watch_norms`` definition (the same trees, leaves and keys)
    summed in float64 on the host."""
    def norm(tree):
        leaves = [np.asarray(x, np.float64)
                  for x in jax.tree_util.tree_leaves(tree)
                  if jnp.issubdtype(jnp.result_type(x), jnp.floating)]
        return float(np.sqrt(sum(np.sum(x * x) for x in leaves)))

    out = {"watch/param_norm": norm(state.params)}
    out.update({f"watch/param_norm/{k}": norm(v)
                for k, v in state.params.items()})
    mus = [s.mu for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    out["watch/grad_ema_norm"] = norm(mus)
    return out


def test_watch_norms_match_jax(pretrained):
    """``watch_norms`` against JAX's at init and after 2 AdamW steps (the
    JAX CLI's masked whole-trunk freeze around adamw, lr 1e-2) from equal
    states and the same seeded gradients: the same keys (the global,
    enc/mlm/itm and the first-moment norm, 0 before the first update), each
    within 1e-5 relative of JAX's definition summed in float64, and of
    JAX's own f32 value for the heads and the moments.  JAX's jitted f32
    sum on the CPU is not a reference for ``enc`` and the global norm: it
    adds the squares of the trunk's 2.4M-entry kernels in an order that
    reads 240.85 where float64 reads 250.97 (the port's f32: 250.971)."""
    cfg, _, params, stats, _ = pretrained
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = joptim.masked_trainable(
        joptim.adamw(1e-2, cfg.beta1, cfg.beta2, cfg.eps, 0.01),
        lambda p: jresnet.cnn_freeze_mask(p, ("enc", "img_encoder")))
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                            batch_stats=stats, opt_state=tx.init(params))
    tm = torch_model(cfg, params, stats)
    ttx = toptim.Accumulate(toptim.adamw(toptim.trainable(tm), 1e-2,
                                         cfg.beta1, cfg.beta2, cfg.eps,
                                         0.01), 1)

    def check():
        want = jlogging.watch_norms(state)
        exact = _norms_float64(state)
        got = watch_norms(tm, ttx)
        assert set(got) == set(want) == set(exact)
        for k in want:
            np.testing.assert_allclose(got[k], exact[k], rtol=1e-5,
                                       atol=0, err_msg=k)
            if k.endswith(("mlm", "itm", "grad_ema_norm")):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=0, err_msg=k)
        return got

    got = check()
    assert got["watch/grad_ema_norm"] == 0.0
    assert {"watch/param_norm/enc", "watch/param_norm/mlm",
            "watch/param_norm/itm"} <= set(got)
    rng = np.random.default_rng(8)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        state = state.replace(
            params=jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                          updates), opt_state=opt_state)
        sd = cxrbert_state_dict_from_flax(grads, stats)
        for name, p in tm.named_parameters():
            p.grad = torch.from_numpy(np.array(sd[name])) \
                if p.requires_grad else None
        ttx.step()
    assert check()["watch/grad_ema_norm"] > 0


def test_pretrain_parser_takes_the_new_flags_with_jax_defaults():
    """--test_dataset, --watch_interval, --profile_dir, --hf_bert_checkpoint
    (alias --bert_init_path), --resnet_init_path and --save_interval parse
    with the JAX CLI's defaults, and a given value lands where JAX's does."""
    from medvill_torch.cli import pretrain_main as tmain
    from medvill_tpu.cli import pretrain_main as jmain

    base = ["--train_dataset", "t.jsonl", "--vocab_file", "v.txt"]
    flags = ("test_dataset", "watch_interval", "profile_dir",
             "hf_bert_checkpoint", "resnet_init_path", "save_interval")
    got = vars(tmain.build_parser().parse_args(base))
    want = vars(jmain.build_parser().parse_args(base))
    assert {f: got[f] for f in flags} == {f: want[f] for f in flags}
    given = base + ["--test_dataset", "e.jsonl", "--watch_interval", "7",
                    "--profile_dir", "p", "--bert_init_path", "b.bin",
                    "--resnet_init_path", "r.pth"]
    got = vars(tmain.build_parser().parse_args(given))
    want = vars(jmain.build_parser().parse_args(given))
    assert {f: got[f] for f in flags} == {f: want[f] for f in flags}
    assert tmain.config_from_args(
        tmain.build_parser().parse_args(given)).test_dataset == "e.jsonl"
