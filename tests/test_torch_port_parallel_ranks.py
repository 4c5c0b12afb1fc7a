"""The port's scale-out on two gloo processes on the CPU
(tests/torch_parallel_worker.py, started once by a module fixture, one
torch thread each), held against JAX's single-process step on the
concatenated batch and against the port's own single-process step:

- data parallelism: the pretrain step (MLM with a different number of
  masked tokens on each rank, ITM, gradients, three AdamW steps) equals
  JAX's on the global batch; the finetune step with drop-worst and the
  classification step with train-mode BatchNorm (ranks of 2 and 1 rows)
  equal the single-process step on the global batch;
- ``--zero1`` equals replicated over three AdamW and two BertAdam steps,
  with half the moment elements on each rank;
- ``--model_parallel 2`` equals 1: loss, gradients and three steps, and
  BertAdam's per-tensor clip (finetune, classification, with and without
  ZeRO-1) reads each whole tensor's norm;
- the train-mode BatchNorm op of two ranks equals one process's in
  float64.

The training CLIs on two ranks are in test_torch_port_parallel_clis.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch.convert import cxrbert_state_dict_from_flax
from medvill_tpu.models import resnet as jresnet
from medvill_tpu.train import optim as joptim
from medvill_tpu.train import pretrain as jpre
from tests import test_torch_port_classification as clf_t
from tests import test_torch_port_finetune as ft_t
from tests import test_torch_port_pretrain as pre_t
from tests.torch_port_support import launch_ranks, wait_ranks
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)



def _numeric(b):
    return {k: np.asarray(v) for k, v in b.items()
            if np.asarray(v).dtype.kind in "biuf"}


def _sd(params, stats):
    return {k: torch.from_numpy(np.array(v))
            for k, v in cxrbert_state_dict_from_flax(params, stats).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(what JAX computes, [rank 0's results, rank 1's]): the two ranks
    start, the scenarios' configurations, weights and global batches (4
    rows for pretrain and finetune, 3 for classification) are written for
    them, and JAX's single-process steps computed while they run."""
    d = str(tmp_path_factory.mktemp("parallel"))
    path, out = os.path.join(d, "inputs.pt"), os.path.join(d, "out")
    os.makedirs(out)
    # the ranks start (and import) while the inputs are made
    procs = launch_ranks(path, out, "steps")
    try:
        pre = dataclasses.replace(pre_t.jax_cfg(
            use_flash_attention=True, mlm_gather_bound=4), batch_size=4)
        model, params, stats = pre_t.jax_variables(pre, seed=3)
        batch = pre_t.batches(pre, 1, seed=3)[0]
        pix = pre_t._jax_pixel_indices(pre, seed=5, step=0)
        pre3 = dataclasses.replace(pre_t.jax_cfg(
            encoder="full-fiber", num_image_embeds=4, lr=1e-3,
            gradient_accumulation_steps=2), batch_size=4)
        model3, params3, stats3 = pre_t.jax_variables(pre3, seed=4)
        data3 = pre_t.batches(pre3, 3, seed=4)
        ft = ft_t.jax_cfg("report_generation")
        clf = clf_t.jax_cfg()
        cls_id, sep_id = clf_t.ids()
        inp = {
            "pre": {"cfg": pre_t.port_cfg(pre), "sd": _sd(params, stats),
                    "batch": _numeric(batch), "pix": pix},
            "pre3": {"cfg": pre_t.port_cfg(pre3),
                     "sd": _sd(params3, stats3),
                     "batches": [_numeric(b) for b in data3]},
            "ft": {"cfg": ft_t.port_cfg(ft), "ratio": 0.5,
                   "batches": [_numeric(b) for b in
                               ft_t.make_batches(ft, 2, seed=2)]},
            "clf": {"cfg": clf_t.port_cfg(clf),
                    "n_labels": len(clf_t.LABELS), "cls": cls_id,
                    "sep": sep_id,
                    "batches": [_numeric(b)
                                for b in clf_t.batches(clf, 2, seed=3)]}}
        torch.save(inp, path + ".tmp")
        os.replace(path + ".tmp", path)

        def loss_fn(p):
            return jpre.pretrain_loss_and_metrics(
                model, p, stats, jax.tree_util.tree_map(jnp.asarray, batch),
                jax.random.PRNGKey(0), jnp.asarray(pix), pre, train=True)

        (_, (jm, jstats)), jg = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = joptim.masked_trainable(
            joptim.accumulate(joptim.adamw(pre3.lr, pre3.beta1, pre3.beta2,
                                           pre3.eps, pre3.weight_decay), 2),
            lambda p: jresnet.cnn_freeze_mask(p, ("enc", "img_encoder")))
        state = jpre.TrainState(step=jnp.zeros([], jnp.int32),
                                params=params3, batch_stats=stats3,
                                opt_state=tx.init(params3))
        step = jax.jit(jpre.make_train_step(model3, tx, pre3))
        for b in data3:
            state, _ = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                            jax.random.PRNGKey(0))
        want = {"metrics": jm,
                "grads": cxrbert_state_dict_from_flax(jg, stats),
                "stats": cxrbert_state_dict_from_flax(params, jstats),
                "steps": cxrbert_state_dict_from_flax(state.params,
                                                      state.batch_stats),
                "before3": cxrbert_state_dict_from_flax(params3, stats3)}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return want, wait_ranks(procs, out)


@pytest.fixture(scope="module")
def want(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[1]


def _close(got: dict, want: dict, atol_of, names=None):
    for k in names or want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=atol_of(w), err_msg=k)


def test_data_parallel_pretrain_gradients_equal_jax_on_the_global_batch(
        want, ranks):
    """Two ranks of 2 rows against JAX on the 4: the summed metrics
    within 1e-5 (the MLM loss over the global count of masked tokens,
    which the ranks do not share), every gradient within 1e-3 of its
    tensor's largest entry (the tolerance of
    test_torch_port_pretrain.py's single-process test, whose train-mode
    trunk sits 2e-3 of scale from JAX's), the BatchNorm statistics after
    the forward (global batch statistics) within 1e-3; both ranks hold
    the same gradients."""
    got, other = ranks[0]["dp_grads"], ranks[1]["dp_grads"]
    assert got["local_mlm_total"] != other["local_mlm_total"]
    assert got["local_mlm_total"] + other["local_mlm_total"] == \
        int(got["metrics"]["mlm_total"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(got["metrics"][k]), float(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert len(got["grads"]) == 2 * 16 + 16
    _close(got["grads"], want["grads"],
           lambda w: 1e-3 * max(np.abs(w).max(), 1e-3), names=got["grads"])
    _close(got["stats"], want["stats"], lambda w: 1e-3, names=got["stats"])
    for k, v in got["grads"].items():
        assert torch.equal(v, other["grads"][k]), k


def test_data_parallel_adamw_steps_equal_jax(want, ranks):
    """Three AdamW micro-steps at accumulation 2 over three global batches
    (one update, then a gradient summed and pending): every parameter
    within 5e-4 of JAX's, and of the single-process port's
    (test_torch_port_pretrain.py's tolerance: one Adam step moves an entry
    by up to 1e-3, and Adam turns the rounding of near-zero gradient
    entries into such steps), BatchNorm statistics 1e-3, the 48 trainable
    tensors moved, the losses 1e-5 from the single-process port's."""
    got, ref = ranks[0]["dp_steps"]
    moved = 0
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), want["steps"][k], rtol=0,
                                   atol=5e-4, err_msg=k)
        np.testing.assert_allclose(v.numpy(), ref["params"][k].numpy(),
                                   rtol=0, atol=5e-4, err_msg=k)
        moved += not np.array_equal(v.numpy(), want["before3"][k])
    assert moved == 48
    _close(got["buffers"], want["steps"], lambda w: 1e-3,
           names=list(got["buffers"]))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


def test_data_parallel_batch_norm_equals_one_process_in_float64(ranks):
    """Train-mode BatchNorm of ranks of 3 rows against one process over the
    6 (float64, the op alone): output, input gradient, weight and bias
    gradients and the running statistics (biased variance) within 1e-12:
    the statistics are the global batch's, the backward's two reductions
    too, and each rank's parameter gradient is its share."""
    got, ref = ranks[0]["dp_batch_norm"]
    for k in ("y", "dx", "dw", "db", "mean", "var"):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


def _trunk(name: str) -> bool:
    return "img_encoder.model." in name


@pytest.mark.parametrize("case", ["dp_finetune", "dp_classify"])
def test_data_parallel_equals_the_single_process_step(ranks, case):
    """Finetune with drop-worst 0.5 (the two rows kept are chosen from the
    global four) and classification with the trunk trained under
    train-mode BatchNorm (ranks of 2 and 1 rows): the first step's loss
    1e-5; every gradient outside the trunk within 1e-4 of its tensor's
    scale (floor 1e-6: the key biases' gradient is zero up to rounding);
    the trunk's in relative RMS within 5e-2 (its f32 gradients are not
    comparable tensor by tensor between two orders of summation: a ReLU
    input within rounding of 0 flips branch, test_torch_port_
    classification.py; the BatchNorm op itself is held in float64 above);
    after two BertAdam steps the losses 1e-5 and every parameter within one
    step of the single-process run's (lr: Adam turns the rounding of
    near-zero gradient entries into steps of either sign), BatchNorm
    statistics 1e-3."""
    got, ref = ranks[0][case]
    np.testing.assert_allclose(float(got["metrics"]["loss"]),
                               float(ref["metrics"]["loss"]), rtol=1e-5)
    assert got["grads"].keys() == ref["grads"].keys()
    trunk = [k for k in ref["grads"] if _trunk(k)]
    assert bool(trunk) == (case == "dp_classify")
    for k, v in got["grads"].items():
        w = ref["grads"][k]
        if not _trunk(k):
            np.testing.assert_allclose(
                v.numpy(), w.numpy(), rtol=0,
                atol=1e-4 * max(w.abs().max().item(), 1e-2), err_msg=k)
    if trunk:
        num = sum(((got["grads"][k] - ref["grads"][k]) ** 2).sum()
                  for k in trunk)
        den = sum((ref["grads"][k] ** 2).sum() for k in trunk)
        assert float((num / den).sqrt()) < 5e-2
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    lr = ranks[0][case + "_lr"]
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), ref["params"][k].numpy(),
                                   rtol=0, atol=lr, err_msg=k)
    for k, v in got.get("buffers", {}).items():
        np.testing.assert_allclose(v.numpy(), ref["buffers"][k].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_zero1_equals_replicated_with_half_the_moments(ranks):
    """AdamW (pretrain) and BertAdam with its per-tensor clip (finetune):
    the same parameters and losses as the replicated optimizer, the
    gathered moments equal, and each rank holding half the moment
    elements: the two ranks' add up to the whole, and each is off half by
    at most the alignment padding (under 128 elements a tensor) its span
    holds instead."""
    held = [ranks[r]["zero1_steps"]["moment_elements"] for r in range(2)]
    assert sum(held) == ranks[0]["zero1_steps"]["full_moment_elements"]
    for r in range(2):
        z, rep = ranks[r]["zero1_steps"], ranks[r]["dp_steps"][0]
        assert abs(z["moment_elements"] - z["full_moment_elements"] / 2) \
            <= 128 * len(rep["tx"]["state"])
        for k, v in z["params"].items():
            np.testing.assert_allclose(v.numpy(), rep["params"][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        for a, b in zip(z["tx"]["state"], rep["tx"]["state"]):
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                           rtol=1e-5, atol=1e-9)
        zf, rf = ranks[r]["zero1_finetune"], ranks[r]["dp_finetune"][0]
        np.testing.assert_allclose(zf["loss"], rf["loss"], rtol=1e-6)
        for k, v in zf["params"].items():
            np.testing.assert_allclose(v.numpy(), rf["params"][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        assert zf["tx"]["host"] == rf["tx"]["host"]


def test_model_parallel_two_equals_one(ranks):
    """--model_parallel 2 (one head and half the FFN per rank) against one
    process: loss and metrics 1e-5, every gradient (gathered) within 1e-5
    of its scale, three AdamW steps within 1e-5, and with ZeRO-1 on top
    the same; both ranks hold the same replicated tensors."""
    got, ref = ranks[0]["tp_grads"]
    other, _ = ranks[1]["tp_grads"]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(got["metrics"][k]), float(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["grads"].keys() == ref["grads"].keys()
    for k, v in got["grads"].items():
        w = ref["grads"][k]
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(w.abs().max().item(),
                                                   1e-3), err_msg=k)
        assert torch.equal(v, other["grads"][k]), k
    steps, ref_steps = ranks[0]["tp_steps"]
    z = ranks[0]["tp_zero1_steps"]
    for k, v in steps["params"].items():
        np.testing.assert_allclose(v.numpy(), ref_steps["params"][k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(z["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["finetune", "classify"])
def test_model_parallel_bert_adam_clips_by_the_whole_tensor(ranks, case):
    """BertAdam (finetune, classification) at --model_parallel 2, alone and
    with ZeRO-1, under a clip that binds on every tensor: each slice and
    each span is clipped by its whole tensor's norm, as JAX clips the
    global array (medvill_tpu/train/optim.py:51-67).  The moments hold the
    clipped gradients: within 1e-4 of the largest tensor's moment of one
    process's (a piece clipped by its own norm is off by tens of per cent;
    the key biases, whose gradient is rounding, are not clipped and their
    moments are rounding too); the losses 1e-5, the parameters within 1e-5
    (a tenth of the lr) after two steps; both ranks' gathered state
    equal."""
    got, ref = ranks[0][f"tp_{case}"]
    other, _ = ranks[1][f"tp_{case}"]
    zero1 = ranks[0][f"tp_zero1_{case}"]
    top = {k: max(float(row[k].abs().max()) for row in ref["tx"]["state"]
                  if k in row) for k in ("m", "v")}
    for run in (got, zero1):
        np.testing.assert_allclose(run["loss"], ref["loss"], rtol=1e-5)
        for a, b in zip(run["tx"]["state"], ref["tx"]["state"]):
            assert a.keys() == b.keys()
            for k in a:
                w = b[k].numpy()
                np.testing.assert_allclose(a[k].numpy(), w, rtol=0,
                                           atol=1e-4 * top[k], err_msg=k)
        for k, v in run["params"].items():
            np.testing.assert_allclose(v.numpy(), ref["params"][k].numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
    for k, v in got["params"].items():
        assert torch.equal(v, other["params"][k]), k


