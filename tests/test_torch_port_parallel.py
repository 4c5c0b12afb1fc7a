"""The port's scale-out rules held against the JAX package's, in one
process (medvill_torch/parallel.py against medvill_tpu/core/mesh.py and
medvill_tpu/data/pretrain.py): the tensor-parallel spec of every exported
parameter, ZeRO-1's spans, the head-divisibility and batch refusals,
and the loader's per-rank shards.  The two-process runs are in
test_torch_port_parallel_ranks.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medvill_torch import parallel
from medvill_torch.data import pretrain as tdata
from medvill_torch.models.cxrbert import CXRBERT as TorchCXRBERT
from medvill_torch.train import optim as toptim
from medvill_torch.train import pretrain as tpre
from medvill_tpu.core import mesh
from medvill_tpu.core.config import BertConfig
from medvill_tpu.core.torch_export import export_cxrbert_state_dict
from medvill_tpu.data import pretrain as jdata
from medvill_tpu.train import pretrain as jpre
from tests import test_torch_port_pretrain as pre_t
from tests.torch_port_support import one_thread  # noqa: F401 (autouse fixture)

P = jax.sharding.PartitionSpec


def _exported_specs(bert: BertConfig):
    """{torch name: (JAX's PartitionSpec, ndim)} of a CXRBERT's exported
    state dict: each flax leaf is a constant array holding its own index,
    so the exported tensor names the leaf it came from."""
    cfg = dataclasses.replace(pre_t.jax_cfg(), bert=bert)
    model = jpre.build_model(cfg)
    L = cfg.seq_len + 1
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key}, jnp.zeros((2, 1), jnp.int32),
        jnp.zeros((2, L), jnp.int32), jnp.zeros((2, 2), jnp.int32),
        jnp.ones((2, L), jnp.int32), jnp.zeros((2, 64, 64, 3)),
        jnp.zeros((2, 1), jnp.int32),
        pixel_indices=jnp.arange(cfg.image.num_image_embeds)),
        jax.random.PRNGKey(0))
    specs = []

    def mark(path, leaf):
        specs.append(mesh.tp_spec(jax.tree_util.keystr(path),
                                  len(leaf.shape)))
        return np.broadcast_to(np.float32(len(specs) - 1), leaf.shape)

    params = jax.tree_util.tree_map_with_path(mark, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(mark, shapes["batch_stats"])
    sd = export_cxrbert_state_dict(params, stats)
    return {name: (specs[int(np.asarray(a).flat[0])], np.ndim(a))
            for name, a in sd.items()}


def _as_torch_dim(spec: P, ndim: int):
    """JAX's spec of a flax leaf as the sharded dim of the torch tensor:
    a Dense kernel is [in, out], a torch Linear weight [out, in]."""
    if spec == P():
        return None
    dim = list(spec).index(mesh.MODEL_AXIS)
    return ndim - 1 - dim if ndim == 2 else dim


@pytest.mark.parametrize("bert", ["test-tiny", "bert-base-scratch"])
def test_tp_spec_matches_jax_on_every_exported_name(bert):
    """Column-parallel query/key/value/intermediate (weight dim 0 and the
    bias), row-parallel attention.output.dense and output.dense (weight dim
    1), everything else replicated: the port's rule on each torch name
    equals JAX's on the flax leaf exported under it."""
    specs = _exported_specs(BertConfig.from_name(bert, vocab_size=64))
    layers = BertConfig.from_name(bert).num_hidden_layers
    sharded = 0
    for name, (spec, ndim) in specs.items():
        got = parallel.tp_spec(name, ndim)
        assert got == _as_torch_dim(spec, ndim), name
        sharded += got is not None
    # per layer: q/k/v/intermediate weight and bias, two row weights
    assert sharded == layers * 10


def _tiny_state(seed=0):
    cfg = pre_t.port_cfg(pre_t.jax_cfg(encoder="full-fiber",
                                       num_image_embeds=4))
    return cfg, tpre.init_state(cfg, seed=seed, device="cpu")


def test_tp_dims_leave_an_indivisible_dim_replicated():
    """mesh.py:135-141: a dim the model axis does not divide stays whole
    (test-tiny's intermediate 64 is divided by 2 and 4, not by 3)."""
    _, ts = _tiny_state()
    two = parallel.tp_dims(ts.model, 2)
    assert len(two) == 2 * 10
    assert parallel.tp_dims(ts.model, 1) == {}
    three = parallel.tp_dims(ts.model, 3)
    assert three == {}  # hidden 32 and intermediate 64: neither divides


def test_model_parallel_must_divide_the_heads_and_the_world():
    """JAX's message (mesh.py:215-218) before the world size is read; then
    one process cannot hold two model ranks."""
    with pytest.raises(ValueError, match="must divide num_attention_heads=12"):
        parallel.configure(5, num_heads=12)
    with pytest.raises(ValueError, match="must divide num_attention_heads"):
        mesh.cli_mesh_and_place((-1,), model_parallel=5, num_heads=12)
    with pytest.raises(ValueError, match="must divide the world size 1"):
        parallel.configure(2, num_heads=12)
    assert parallel.configure(1, num_heads=12) is None


class _Group:
    """A one-rank stand-in for a process group (no collective runs on the
    paths this test takes)."""


def test_zero1_chunks_each_tensor_flat_across_the_data_ranks():
    """Which moment elements ZeRO-1 keeps on rank r of n: the trainable
    tensors packed flat in the optimizer's order, each from a 512-byte
    boundary (zero-padded to n equal spans), span r, cut at the tensors'
    edges into pieces that keep their tensor's group and the state it had
    so far; the parameters and their gradients become views of the flat
    buffers, each at a multiple of 512 bytes into them.  JAX
    shards each moment on its first free dim the data axis divides instead
    (zero1_shard), which keeps the same 1/n of the elements wherever that
    dim exists."""
    for n in (2, 3):
        for r in range(n):
            _, ts = _tiny_state()
            opt = ts.tx.optimizer
            groups = [list(g["params"]) for g in opt.param_groups]
            flat = [p for g in groups for p in g]
            before = [p.detach().clone() for p in flat]
            opt.state[flat[0]]["exp_avg"] = torch.full_like(flat[0], 2.0)
            parallel._LAYOUT = parallel.Layout(n, r, n, 1, _Group(), _Group())
            try:
                z = parallel.Zero1(opt)
            finally:
                parallel.reset()
            S = z.span.numel()
            assert z.params == flat and z.flat.numel() == n * S
            used = torch.zeros(n * S, dtype=torch.bool)
            for p, w, a in zip(flat, before, z.offsets):
                assert p.data_ptr() == z.flat[a:].data_ptr()
                assert a * 4 % 512 == 0 and torch.equal(p, w)
                assert p.grad.data_ptr() == z.flat_grad[a:].data_ptr()
                used[a:a + p.numel()] = True
            # padding: under 512 bytes a tensor, under n elements at the end
            assert n * S - used.sum() < 128 * len(flat) + n
            assert not z.flat[~used].any()
            pieces = [q for g in opt.param_groups for q in g["params"]]
            assert torch.equal(torch.cat([q.detach() for q in pieces]),
                               z.span[used[r * S:(r + 1) * S]])
            at = {id(q): i for i, q in enumerate(pieces)}
            tensor_at = {id(p): t for t, p in enumerate(flat)}
            for g, ps in zip(opt.param_groups, groups):
                assert {z.owner[at[id(q)]] for q in g["params"]} <= \
                    {tensor_at[id(p)] for p in ps}
            for q, t, start in z.pieces:
                assert q.data_ptr() == z.span.data_ptr() + 4 * (
                    z.offsets[t] + start - r * S)
                if t == 0:
                    assert torch.equal(opt.state[q]["exp_avg"],
                                       torch.full_like(q, 2.0))
                else:
                    assert not opt.state[q]


def test_classification_and_retrieval_refuse_a_batch_the_data_ranks_split():
    """A global batch the data ranks do not divide is refused, as JAX's
    placement of a data-sharded batch refuses it (a rank with no rows would
    average a loss over none); nothing to check without a layout."""
    parallel.check_global_batch(3, "--batch_sz")
    parallel._LAYOUT = parallel.Layout(4, 0, 2, 2, _Group(), _Group())
    try:
        parallel.check_global_batch(4, "--batch_sz")
        with pytest.raises(ValueError, match="--batch_sz 3 must be divisible "
                                             "by the 2 data ranks"):
            parallel.check_global_batch(3, "--batch_sz")
        with pytest.raises(ValueError, match="must be divisible"):
            parallel.check_global_batch(1, "2 x --batch_size")
    finally:
        parallel.reset()


class _Indexed:
    """A dataset whose sample is its own index (no shared stream)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("n,B,shards", [(23, 3, 2), (24, 2, 3), (9, 4, 2)])
def test_batch_loader_shards_equal_jax(n, B, shards):
    """Each rank's batches equal JAX's BatchLoader(num_shards, shard_index)
    order over two epochs, the shards of one epoch are disjoint, cover
    the global floor, and every rank yields the same count (the global
    floor); after skip_next the rest of each shard equals its tail."""
    got = {}
    for r in range(shards):
        t = tdata.BatchLoader(_Indexed(n), B, seed=5, num_shards=shards,
                              shard_index=r)
        j = jdata.BatchLoader(_Indexed(n), B, seed=5, num_shards=shards,
                              shard_index=r)
        assert len(t) == len(j) == n // (B * shards)
        for _ in range(2):
            tb = [b["i"].tolist() for b in t]
            jb = [b["i"].tolist() for b in j]
            assert tb == jb
        got[r] = tb
        t.skip_next(1)
        j.skip_next(1)
        assert [b["i"].tolist() for b in t] == [b["i"].tolist() for b in j]
    seen = [i for r in got for b in got[r] for i in b]
    assert len(seen) == len(set(seen)) == (n // (B * shards)) * B * shards


def test_sharded_loader_refuses_drop_last_false():
    with pytest.raises(ValueError, match="drop_last=False with num_shards"):
        tdata.BatchLoader(_Indexed(8), 2, drop_last=False, num_shards=2)
    with pytest.raises(ValueError, match="drop_last=False with num_shards"):
        jdata.BatchLoader(_Indexed(8), 2, drop_last=False, num_shards=2)


def test_single_process_paths_need_no_process_group():
    """Without a launcher's variables nothing joins a group and every
    helper is the identity: the single-process step is unchanged."""
    assert not parallel.launched() and parallel.layout() is None
    dev = torch.device("cpu")
    assert parallel.initialize(dev) == dev
    assert parallel.global_any(True) and not parallel.global_any(False)
    assert parallel.rank_seed(123) == 123 and parallel.is_main()
    t = torch.arange(3)
    assert parallel.data_sum(t) is t
    assert parallel.local_rows({"x": t})["x"] is t
    assert parallel.loader_shards() == {}
    _, ts = _tiny_state()
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    parallel.place(ts, zero1=True)
    assert ts.model.tp_dims == {}
    assert isinstance(ts.tx.optimizer, toptim.AdamW)
    for k, v in parallel.full_state_dict(ts.model).items():
        assert torch.equal(v, before[k]), k
    assert isinstance(ts.model, TorchCXRBERT)


@pytest.mark.parametrize("cli", ["pretrain_main", "finetune_main",
                                 "classification_main", "retrieval_main"])
def test_training_clis_take_every_jax_flag(cli):
    """The four training CLIs accept every flag of JAX's (the mesh pair
    included, with its defaults: medvill_tpu/cli/__init__.py:29-46); the
    port adds --device."""
    import importlib

    def defaults(module):
        p = importlib.import_module(f"{module}.cli.{cli}").build_parser()
        return {a.dest: a.default for a in p._actions if a.dest != "help"}

    port, jax_ = defaults("medvill_torch"), defaults("medvill_tpu")
    assert set(jax_) <= set(port) and set(port) - set(jax_) <= {"device"}
    assert {k: port[k] for k in ("model_parallel", "zero1")} == \
        {k: jax_[k] for k in ("model_parallel", "zero1")} == \
        {"model_parallel": 1, "zero1": False}
