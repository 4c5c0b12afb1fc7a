"""k training micro-steps per dispatch in the port (train/dispatch.py), and
what it rests on, on the CPU:

- train-mode BatchNorm keeps only the compute-dtype input and the
  per-channel statistics (no f32 copy of an activation), and moves the
  running statistics as flax does;
- the kernels' seeds given as a host int or as a device word give the same
  masks (the plain versions of K1-K4);
- BertAdam's lr as a device scalar, against the float lr it had;
- ``dispatch_loader(k)`` against the JAX package's ``grouped_batches``;
- each step factory's k = 2 dispatch against two single steps, bit for bit,
  at dropout 0 and 0.1;
- the finetune and pretrain dispatches against JAX's
  ``make_multi_train_step(k=2)`` at dropout 0, in f32;
- the finetune CLI at ``--steps_per_dispatch`` 1, 2 and 3, and the flag in
  every training CLI's parser.

On the CPU a dispatch is a loop of eager micro-steps; the CUDA graphs are
held against eager steps on the card (tests/test_torch_port_cuda.py and
chip_smoke.py's graph-steps phase)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.cli import (classification_main, finetune_main,
                               pretrain_main, retrieval_main)
from medvill_torch.convert import (_trunk, cxrbert_state_dict_from_flax,
                                   vlp_state_dict_from_flax)
from medvill_torch.data import pretrain as tdata
from medvill_torch.models import resnet as tresnet
from medvill_torch.ops import flash_attention as tfa
from medvill_torch.ops import fused_ln as tfl
from medvill_torch.ops.dropout import DeviceSeed
from medvill_torch.train import classify as tclf
from medvill_torch.train import dispatch
from medvill_torch.train import finetune as tft
from medvill_torch.train import optim as toptim
from medvill_torch.train import pretrain as tpre
from medvill_torch.train import retrieve as tret
from medvill_tpu.data import pretrain as jdata
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.train import finetune as jft
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import pretrain as jpre
from tests import test_torch_port_classification as clf_t
from tests import test_torch_port_finetune as ft_t
from tests import test_torch_port_pretrain as pre_t
from tests import test_torch_port_retrieval as ret_t
from tests.test_torch_port_finetune import base  # noqa: F401 (fixture)
from tests.test_torch_port_finetune_data import TINY, _write_reports
from tests.torch_port_support import (perturb, random_batch_stats,
                                      sub_state_dict)
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

IMG = 64


# --- Part A: train-mode BatchNorm --------------------------------------------

def test_train_mode_batchnorm_saves_no_f32_activation():
    """One trained bf16 trunk forward at 64 px, batch 3, under
    saved_tensors_hooks: no f32 tensor of an activation's size (4-D, the
    batch leading) is saved, and the activation-sized bytes saved (each
    storage once) are the bf16 conv and ReLU outputs (a block's output is
    its last ReLU's) and what the stem adds: the bf16 image the first
    convolution reads and the max pool's output and int64 indices.  The
    earlier f32 arithmetic saved several f32 copies per BatchNorm on top."""
    B = 3
    torch.manual_seed(0)
    trunk = tresnet.ResNet50Trunk(dtype=torch.bfloat16)
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, IMG, IMG, 3), dtype=np.uint8))
    conv_out, main_out = [], []
    downsample = {id(blk.downsample[0]) for stage in trunk.model[4:]
                  for blk in stage if blk.downsample is not None}
    real_conv = tresnet._conv

    def conv(c, x, dtype):
        y = real_conv(c, x, dtype)
        conv_out.append(y.numel())
        if id(c) not in downsample:
            main_out.append(y.numel())  # a ReLU follows (stem, block convs)
        return y

    saved = {}

    def pack(t):
        if t.dim() == 4 and t.shape[0] == B:
            saved[(t.untyped_storage().data_ptr(), t.storage_offset(),
                   tuple(t.shape), t.dtype)] = t
        return t

    tresnet._conv = conv
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            trunk(img, train=True)
    finally:
        tresnet._conv = real_conv
    assert len(conv_out) == 53 and len(main_out) == 49
    assert not [k for k in saved if k[3] == torch.float32]
    total = sum(t.numel() * t.element_size() for t in saved.values())
    pooled = B * 64 * (IMG // 4) ** 2
    want = 2 * (sum(conv_out) + sum(main_out)) + 2 * B * 3 * IMG * IMG \
        + pooled * (2 + 8)
    assert total == want
    # the bf16 conv, ReLU and block outputs, plus the stem's 5.6%
    assert total < 1.06 * 2 * (sum(conv_out) + sum(main_out))


def test_train_mode_running_statistics_match_flax_after_two_forwards():
    """Two train-mode forwards of the trunk on normalized float64 images,
    float64 on both sides, from random running statistics: every running
    mean and variance (flax's momentum 0.9 with the biased batch variance,
    recovered here from the saved inverse std) within 1e-6 of flax's
    batch_stats."""
    rng = np.random.default_rng(2)
    imgs = [rng.standard_normal((2, IMG, IMG, 3)) for _ in range(2)]
    with jax.enable_x64():
        trunk = jresnet.ResNet50Trunk(dtype=jnp.float64)
        v = jax.jit(trunk.init)({"params": jax.random.PRNGKey(2)},
                                jnp.asarray(imgs[0]))
        params = perturb(v["params"], rng, 0.02)
        stats = random_batch_stats(v["batch_stats"], rng)
        apply = jax.jit(lambda p, s, x: trunk.apply(
            {"params": p, "batch_stats": s}, x, train=True,
            mutable=["batch_stats"])[1]["batch_stats"])
        moved = stats
        for x in imgs:
            moved = jax.tree_util.tree_map(np.asarray, apply(
                jax.tree_util.tree_map(jnp.float64, params),
                jax.tree_util.tree_map(jnp.float64, moved), jnp.asarray(x)))
    sd = {}
    _trunk(sd, "t", params, stats)
    tt = tresnet.ResNet50Trunk(dtype=torch.float64).double()
    tt.load_state_dict(sub_state_dict(sd, "t."))
    with torch.no_grad():
        for x in imgs:
            tt(torch.from_numpy(x), train=True)
    want = {}
    _trunk(want, "t", params, moved)
    n = 0
    for k, t in tt.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want["t." + k], rtol=0,
                                       atol=1e-6, err_msg=k)
            n += 1
    assert n == 2 * 53


# --- kernel seeds from device memory ---------------------------------------

@pytest.mark.parametrize("add", [0, 0x9E3779B9])
def test_plain_kernels_same_masks_from_host_and_device_seeds(add):
    """K1-K4's plain versions at rate 0.1 from the seed s as a host int and
    from a device word holding base with add, base + add = s mod 2^32:
    identical outputs and keep masks."""
    s = 0x7A3C5E11
    base = np.array([(s - add) & 0xFFFFFFFF], np.uint32).view(np.int32)
    seed_dev = DeviceSeed(torch.from_numpy(base), add)
    g = torch.Generator().manual_seed(0)
    B, L, heads = 2, 70, 2
    q, k, v, do = (torch.randn(B, L, heads, 64, generator=g)
                   for _ in range(4))
    spec = torch.tensor([[0, 30], [2, 50]], dtype=torch.int32)
    kw = dict(img_block=6, l_real=L, family=tfa.FAMILY_PRETRAIN, rate=0.1)
    o1, lse1 = tfa.attn_fwd(q, k, v, spec, seed=s, **kw)
    o2, lse2 = tfa.attn_fwd(q, k, v, spec, seed=seed_dev, **kw)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    for a, b in zip(tfa.attn_bwd(q, k, v, o1, do, lse1, spec, seed=s, **kw),
                    tfa.attn_bwd(q, k, v, o1, do, lse1, spec,
                                 seed=seed_dev, **kw)):
        assert torch.equal(a, b)
    assert torch.equal(tfa.keep_mask(s, B, heads, L, 0.1),
                       tfa.keep_mask(seed_dev, B, heads, L, 0.1))
    x, res, dy = (torch.randn(37, 96, generator=g) for _ in range(3))
    gamma, beta = torch.randn(96, generator=g), torch.randn(96, generator=g)
    lk = dict(rate=0.1, eps=1e-12)
    assert torch.equal(
        tfl.fused_ln_fwd(x, res, gamma, beta, seed=s, **lk),
        tfl.fused_ln_fwd(x, res, gamma, beta, seed=seed_dev, **lk))
    for a, b in zip(tfl.fused_ln_bwd(x, res, gamma, dy, seed=s, **lk),
                    tfl.fused_ln_bwd(x, res, gamma, dy, seed=seed_dev, **lk)):
        assert torch.equal(a, b)
    assert not tfl.keep_mask(s, 37, 96, 0.1).all()


# --- optimizers --------------------------------------------------------------

class _FloatLrBertAdam(toptim.BertAdam):
    """BertAdam as it was: the lr reached the update as a host float."""

    @torch.no_grad()
    def step(self, closure=None):
        scale = self.lr_scale()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.requires_grad]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            norms = torch.stack(torch._foreach_norm(grads))
            clip = torch.clamp(self.max_grad_norm / (norms + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, list(clip.unbind(0)))
            for p in params:
                if not self.state[p]:
                    self.state[p]["m"] = torch.zeros_like(p)
                    self.state[p]["v"] = torch.zeros_like(p)
            m = [self.state[p]["m"] for p in params]
            v = [self.state[p]["v"] for p in params]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - self.b2)
            update = torch._foreach_sqrt(v)
            torch._foreach_add_(update, self.eps)
            update = torch._foreach_div(m, update)
            if group["weight_decay"] > 0:
                torch._foreach_add_(update, params,
                                    alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"] * scale)
        self.opt_step += 1


@pytest.mark.parametrize("schedule", ["warmup_linear", "warmup_cosine"])
def test_bertadam_device_lr_equals_float_lr(schedule):
    """BertAdam with its lr as a device scalar written before each update,
    against the float version over 3 updates with warmup (0.4 of t_total =
    4), decay and a plateau scale of 0.5 from the second update, through
    Accumulate at 2: every parameter within 1e-7 relative (the product
    with the lr rounds on its own where the float version fused it)."""
    torch.manual_seed(0)
    nets = [torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.LayerNorm(16),
                                torch.nn.Linear(16, 4)) for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    opts = [cls(toptim.decay_groups(n, 0.01), 1e-2, 4, warmup=0.4,
                schedule=schedule, weight_decay=0.01)
            for cls, n in ((toptim.BertAdam, nets[0]),
                           (_FloatLrBertAdam, nets[1]))]
    txs = [toptim.Accumulate(o, 2) for o in opts]
    g = torch.Generator().manual_seed(1)
    for i in range(6):
        x = torch.randn(5, 8, generator=g)
        for net, tx in zip(nets, txs):
            net(x).square().sum().backward()
            tx.step()
        if i == 2:
            for o in opts:
                o.plateau = 0.5
    assert [o.opt_step for o in opts] == [3, 3]
    torch.manual_seed(0)
    init = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.LayerNorm(16),
                               torch.nn.Linear(16, 4))
    for a, b, c in zip(nets[0].parameters(), nets[1].parameters(),
                       init.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-7, atol=1e-9)
        assert not torch.equal(a, c)


def test_adamw_is_capturable_only_on_cuda_parameters():
    """torch takes capturable=True on CUDA parameters only: the port's
    AdamW turns it on exactly there (its equality with optax on the card
    is a card test)."""
    opt = toptim.adamw([torch.nn.Parameter(torch.ones(3))], 1e-3)
    assert isinstance(opt, toptim.AdamW)
    assert opt.param_groups[0]["capturable"] is False


# --- batches -----------------------------------------------------------------

def _loader(n, B=2):
    rng = np.random.default_rng(n)
    return [{"a": rng.integers(0, 9, (B, 3)).astype(np.int32),
             "b": rng.random((B, 4, 2), dtype=np.float32)} for _ in range(n)]


@pytest.mark.parametrize("n,k", [(5, 1), (5, 2), (7, 3), (2, 3), (6, 3)])
def test_dispatch_loader_groups_as_jax(n, k):
    """Batch order and contents, groups stacked [k, B, ...] and tail
    batches alone, equal JAX's grouped_batches on the same loader (for
    k = 1 JAX's dispatch_loader yields every batch alone, as here; the
    port's grouped_batches at k = 1 is JAX's too)."""
    loader = _loader(n)
    want = (list(jdata.grouped_batches(loader, k)) if k > 1
            else [(b, False) for b in loader])
    got = list(tdata.dispatch_loader(loader, "cpu", k=k))
    assert [g for _, g in got] == [g for _, g in want]
    for (gb, _), (wb, _) in zip(got, want):
        assert sorted(gb) == sorted(wb)
        for key in wb:
            np.testing.assert_array_equal(gb[key].numpy(), wb[key])
    for (gb, _), (wb, _) in zip(tdata.grouped_batches(loader, k),
                                jdata.grouped_batches(loader, k)):
        for key in wb:
            np.testing.assert_array_equal(gb[key], wb[key])
    keys = list(tdata.dispatch_loader(loader, "cpu", keys=("b",), k=k))
    assert all(list(b) == ["b"] for b, _ in keys)


# --- each step factory: one k = 2 dispatch against two single steps ----------

def _stack(batches):
    return {k: torch.from_numpy(np.stack([np.asarray(b[k]) for b in batches]))
            for k in batches[0]}


def _numeric(b):
    return {k: np.asarray(v) for k, v in b.items()
            if np.asarray(v).dtype.kind in "biuf"}


def _rate(bert, rate):
    return dataclasses.replace(bert, hidden_dropout_prob=rate,
                               attention_probs_dropout_prob=rate)


def _pretrain(rate):
    cfg = pre_t.jax_cfg(gradient_accumulation_steps=2)
    pc = pre_t.port_cfg(cfg)
    pc = dataclasses.replace(pc, bert=_rate(pc.bert, rate))
    return (lambda: tpre.init_state(pc, seed=0, device="cpu"),
            lambda: tpre.make_train_step(pc),
            [_numeric(b) for b in pre_t.batches(cfg, 2, seed=1)])


def _finetune(task):
    def make(rate):
        cfg = ft_t.jax_cfg(task)
        pc = ft_t.port_cfg(cfg)
        pc = dataclasses.replace(pc, bert=_rate(pc.bert, rate))
        return (lambda: tft.init_state(pc, t_total=4, seed=0, device="cpu"),
                lambda: tft.make_train_step(pc),
                [_numeric(b) for b in ft_t.make_batches(cfg, 2, seed=2)])
    return make


def _classify(rate):
    cfg = clf_t.jax_cfg(gradient_accumulation_steps=2)
    pc = clf_t.port_cfg(cfg)
    pc = dataclasses.replace(pc, bert=_rate(pc.bert, rate))
    cls_id, sep_id = clf_t.ids()
    n = len(clf_t.LABELS)
    return (lambda: tclf.init_state(pc, n, t_total=4, seed=0, device="cpu"),
            lambda: tclf.make_train_step(pc, torch.ones(n), cls_id, sep_id),
            [_numeric(b) for b in clf_t.batches(cfg, 2, seed=3)])


def _retrieve(rate):
    cfg = ret_t.jax_cfg(flash=True)
    pc = ret_t.port_cfg(cfg)
    pc = dataclasses.replace(pc, bert=_rate(pc.bert, rate))
    return (lambda: tret.init_state(pc, cxr_bert=True, seed=0, device="cpu"),
            lambda: tret.make_train_step(pc),
            [_numeric(b) for b in ret_t.pair_batches(cfg, 2, seed=4)])


FACTORIES = {"pretrain": _pretrain, "finetune": _finetune("report_generation"),
            "finetune-vqa": _finetune("vqa"), "classify": _classify,
            "retrieve": _retrieve}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("factory", list(FACTORIES))
def test_dispatch_equals_single_steps(factory, rate):
    """From equal states and generators of one seed, one k = 2 dispatch
    over the stacked pair of batches and two single steps give equal
    metrics (stacked [2]) and equal parameters, buffers, step and
    accumulation counters, bit for bit."""
    make_state, make_step, data = FACTORIES[factory](rate)
    s1, s2 = make_state(), make_state()
    step = make_step()
    gen1 = torch.Generator().manual_seed(9)
    singles = [step(s1, {k: torch.from_numpy(v) for k, v in b.items()}, gen1)
               for b in data]
    multi = dispatch.MultiStep(make_step(), 2)(
        s2, _stack(data), torch.Generator().manual_seed(9))
    assert sorted(multi) == sorted(singles[0])
    for name, stacked in multi.items():
        assert stacked.shape[0] == 2
        for i in range(2):
            assert torch.equal(stacked[i], singles[i][name]), name
    assert (s1.step, s1.tx.count) == (s2.step, s2.tx.count) == (
        2, 2 % s1.tx.every)
    for (k, a), b in zip(s1.model.state_dict().items(),
                         s2.model.state_dict().values()):
        assert torch.equal(a, b), k
    if rate > 0:  # the masks differ between micro-steps
        assert not torch.equal(multi["loss"][0], multi["loss"][1])


# --- against JAX's make_multi_train_step ---------------------------------------

def _params_close(got_sd, want, before, atol, stat_atol):
    moved = 0
    for k, t in got_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k], rtol=stat_atol,
                                       atol=stat_atol, err_msg=k)
            continue
        np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=atol,
                                   err_msg=k)
        moved += not np.array_equal(t.numpy(), before[k])
    return moved


def test_pretrain_dispatch_matches_jax():
    """Two dispatches of k = 2 at accumulation 2 (two AdamW updates, lr
    1e-3, full-fiber encoder) against JAX's make_multi_train_step(k=2) on
    the same stacked batches: the stacked losses within 1e-4, every
    parameter within 5e-4 and BN statistic within 1e-3, the tolerances of
    test_torch_port_pretrain.py's single steps; the 48 trainable tensors
    moved."""
    cfg = pre_t.jax_cfg(encoder="full-fiber", num_image_embeds=4, lr=1e-3,
                        gradient_accumulation_steps=2)
    model, params, stats = pre_t.jax_variables(cfg, seed=4)
    tx = joptim.masked_trainable(
        joptim.accumulate(joptim.adamw(cfg.lr, cfg.beta1, cfg.beta2,
                                       cfg.eps, cfg.weight_decay), 2),
        lambda p: jresnet.cnn_freeze_mask(p, ("enc", "img_encoder")))
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                            batch_stats=stats, opt_state=tx.init(params))
    step = jax.jit(jpre.make_multi_train_step(model, tx, cfg, 2))
    data = pre_t.batches(cfg, 4, seed=4)
    groups = [jax.tree_util.tree_map(lambda *x: np.stack(x), *data[i:i + 2])
              for i in (0, 2)]
    want_loss = []
    for g in groups:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, g),
                        jax.random.PRNGKey(0))
        want_loss.append(np.asarray(m["loss"]))

    pc = pre_t.port_cfg(cfg)
    ts = tpre.init_state(pc, device="cpu")
    ts.model.load_state_dict(pre_t.torch_model(cfg, params,
                                               stats).state_dict())
    multi = dispatch.MultiStep(tpre.make_train_step(pc), 2)
    gen = torch.Generator().manual_seed(0)
    got_loss = [multi(ts, pre_t.torch_batch(g), gen)["loss"].numpy()
                for g in groups]
    assert ts.step == 4 and ts.tx.count == 0
    np.testing.assert_allclose(np.concatenate(got_loss),
                               np.concatenate(want_loss), rtol=1e-4)
    want = cxrbert_state_dict_from_flax(state.params, state.batch_stats)
    before = cxrbert_state_dict_from_flax(params, stats)
    assert _params_close(ts.model.state_dict(), want, before, 5e-4,
                         1e-3) == 48 + 1


def test_finetune_dispatch_matches_jax(base):  # noqa: F811
    """One dispatch of k = 2 (two BertAdam updates, lr 1e-3, t_total 4,
    warmup 0.1: lr scales 0 and 0.833) against JAX's
    make_multi_train_step(k=2) on the same stacked batches, report
    generation on the dense bias: the stacked losses within 1e-4, every
    parameter within 5e-4 and BN statistic within 1e-3, the tolerances of
    test_torch_port_finetune.py's single steps."""
    cfg = ft_t.jax_cfg("report_generation", flash=False, lr=1e-3)
    v = ft_t.variables(base)
    model = jft.build_model(cfg)
    tx = joptim.masked_trainable(
        jft.make_finetune_tx(cfg), lambda p: jresnet.cnn_freeze_mask(
            p, ("bert", "img_encoder")))
    state = jpre.TrainState(step=jnp.zeros([], jnp.int32),
                            params=v["params"],
                            batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]))
    step = jax.jit(jft.make_multi_train_step(model, tx, cfg, t_total=4, k=2))
    data = ft_t.make_batches(cfg, 2, seed=4)
    group = jax.tree_util.tree_map(lambda *x: np.stack(x), *data)
    state, m = step(state, jax.tree_util.tree_map(jnp.asarray, group),
                    jax.random.PRNGKey(0))

    tm, pc = ft_t.torch_model(cfg, v)
    ts = tft.init_state(pc, t_total=4, device="cpu")
    ts.model.load_state_dict(tm.state_dict())
    got = dispatch.MultiStep(tft.make_train_step(pc), 2)(
        ts, ft_t.torch_batch(group), torch.Generator().manual_seed(0))
    assert ts.step == 2 and ts.tx.optimizer.opt_step == 2
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(m["loss"]),
                               rtol=1e-4)
    want = vlp_state_dict_from_flax(state.params, state.batch_stats)
    before = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    assert _params_close(ts.model.state_dict(), want, before, 5e-4,
                         1e-3) > 0


# --- the CLIs ----------------------------------------------------------------

def test_finetune_cli_steps_per_dispatch_writes_the_same_model(tmp_path):
    """The finetune CLI from random init over 8 records at batch 2 (4
    micro-steps): --steps_per_dispatch 2 (two groups) and 3 (one group, one
    tail batch alone) write the model.0.bin of --steps_per_dispatch 1, bit
    for bit, and count the same micro-steps."""
    data, vocab = _write_reports(str(tmp_path))
    sds, rows = {}, {}
    for k in (1, 2, 3):
        out = str(tmp_path / f"k{k}")
        res = finetune_main.main([
            "--src_file", data, "--vocab_file", vocab, "--output_dir", out,
            "--num_train_epochs", "1", "--steps_per_dispatch", str(k),
            *TINY])
        rows[k] = res["epochs"][0]
        sds[k] = torch.load(os.path.join(out, "model.0.bin"))
    for k in (2, 3):
        assert rows[k]["micro_steps"] == rows[1]["micro_steps"] == 4
        assert rows[k]["loss"] == rows[1]["loss"]
        assert sorted(sds[k]) == sorted(sds[1])
        for name, t in sds[1].items():
            assert torch.equal(sds[k][name], t), (k, name)


@pytest.mark.parametrize("cli", [pretrain_main, finetune_main,
                                 classification_main, retrieval_main])
def test_training_clis_take_steps_per_dispatch(cli):
    """Each training CLI's parser takes --steps_per_dispatch with JAX's
    default of 1."""
    p = cli.build_parser()
    required = [a for a in p._actions if a.required]
    argv = [x for a in required for x in (a.option_strings[0], "x")]
    assert p.parse_args(argv).steps_per_dispatch == 1
    assert p.parse_args(argv + ["--steps_per_dispatch", "4"]
                        ).steps_per_dispatch == 4
