"""Scale-out: the port's counterpart of medvill_tpu/core/mesh.py, over
``torch.distributed`` (NCCL on the card, gloo on the CPU).

JAX lays one program over a ``(data, model)`` device mesh and lets GSPMD
insert the collectives.  Here each process drives one device, and the
collectives are written out where GSPMD would put them:

- ``initialize(device)`` (``multihost_initialize``): without a launcher's
  variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``, as ``torchrun`` sets them) it does nothing and every
  path stays the single-process one, byte for byte.  With them, even at
  ``WORLD_SIZE=1``, it joins the process group (``nccl`` on CUDA, ``gloo``
  on the CPU) and rank r takes ``cuda:LOCAL_RANK``.  A failing init
  raises.
- ``configure(model_parallel, num_heads)`` (``cli_mesh_and_place``): the
  ``(data, model)`` layout with the model axis fastest (rank = data_rank *
  model + model_rank, as ``make_mesh((-1, mp))`` lays devices out), one
  process group per axis.  The data group exists even at size 1 once the
  process group does, so a one-process launch runs the same collectives
  as a wide one.
- Data parallelism: each rank trains on its own rows.  A step's loss on a
  rank is that rank's share of the GLOBAL batch's loss (the counts that
  normalize it are summed over the data group first: ``data_sum``), so the
  gradients and the additive metrics are summed over the data group
  (``all_reduce_grads``, ``sum_metrics``) and equal the single-process
  step on the concatenated batch.  Drop-worst (``gather_rows``) and
  train-mode BatchNorm (``sync_batch_norm``) read the global batch too.
  The dropout seed folds in the data rank (``rank_seed``); the random-pixel
  draw does not: JAX draws it once per step for the whole global batch.
- Tensor parallelism (``--model_parallel``): ``tp_spec`` is JAX's Megatron
  rule keyed on the port's parameter names; ``shard_state`` slices the
  parameters, their optimizer state and gradients, and marks the BERT
  modules, whose forwards then run the f/g operators (``copy_to_model``,
  ``reduce_from_model``) around their local GEMMs and attention on local
  heads.  Everything else is replicated and sees the same gradient on
  each model rank.
- ``Zero1`` (``zero1_shard``): each data rank keeps 1/N of the optimizer's
  moments: the trainable parameters and their gradients live in two flat
  buffers cut into N equal spans, rank r updates span r.  An update is a
  reduce-scatter of the gradients into the span, the optimizer's update
  of the span's pieces, and an all-gather of the spans, all in place.
  ``WholeNorms`` gives BertAdam's per-tensor clip the norm of each whole
  tensor where ZeRO-1 or tensor parallelism splits it.
- Checkpoints stay in the single-process format: ``full_state_dict`` and
  ``Accumulate.state_dict`` gather what is sharded, rank 0 writes,
  ``load_full`` slices a full file into the local layout.
- ``global_any(flag)``: the preemption flag OR-ed over every rank.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
SEED_STEP = 0x632BE5AB  # folds a rank into a seed (as GOLDEN does a call)


@dataclasses.dataclass(frozen=True)
class Layout:
    world: int
    rank: int
    data: int
    model: int
    data_group: object
    model_group: object

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


_LAYOUT: Optional[Layout] = None


def launched() -> bool:
    """Whether a launcher's variables are in the environment."""
    return "WORLD_SIZE" in os.environ


def initialize(device: torch.device) -> torch.device:
    """Joins the launcher's process group (see the module docstring) and
    returns the device this rank drives: ``device`` itself without a
    launcher or on the CPU, else ``cuda:LOCAL_RANK``."""
    if not launched():
        return device
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but not {missing}: launch "
                           "with torchrun or set all of {ENV}")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method=addr,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(minutes=30),
            **({"device_id": device} if device.type == "cuda" else {}))
    return device


def configure(model_parallel: int = 1,
              num_heads: Optional[int] = None) -> Optional[Layout]:
    """The run's ``(data, model)`` layout (None without a process group and
    a model axis of 1); raises where ``model_parallel`` does not divide the
    head count (medvill_tpu/core/mesh.py:215-218) or the world size."""
    global _LAYOUT
    mp = max(1, int(model_parallel))
    if mp > 1 and num_heads is not None and num_heads % mp:
        raise ValueError(
            f"--model_parallel {mp} must divide num_attention_heads="
            f"{num_heads} (Megatron head sharding)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % mp:
        raise ValueError(f"--model_parallel {mp} must divide the world size "
                         f"{world} (one process per device)")
    if not dist.is_initialized():
        _LAYOUT = None
        return None
    rank, data = dist.get_rank(), world // mp
    groups = {}
    for m in range(mp):  # every rank makes every group, in one order
        ranks = [d * mp + m for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["data"] = g
    for d in range(data):
        ranks = [d * mp + m for m in range(mp)]
        g = dist.new_group(ranks)
        if rank in ranks:
            groups["model"] = g
    _LAYOUT = Layout(world, rank, data, mp, groups["data"], groups["model"])
    return _LAYOUT


def layout() -> Optional[Layout]:
    return _LAYOUT


def reset() -> None:
    """Forgets the layout (the process group stays)."""
    global _LAYOUT
    _LAYOUT = None


def is_main() -> bool:
    """Rank 0, or a run without a process group: the one that logs and
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def loader_shards() -> dict:
    """``BatchLoader``'s ``num_shards``/``shard_index`` of this rank: one
    shard per data rank (the model ranks of one data rank read the same
    batches); none without a layout."""
    if _LAYOUT is None:
        return {}
    return dict(num_shards=_LAYOUT.data, shard_index=_LAYOUT.data_rank)


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def data_states(state):
    """Every data rank's ``state`` (a picklable host value), in data-rank
    order, on every rank (the model ranks of one data rank hold the same);
    None without a layout."""
    if _LAYOUT is None:
        return None
    out = [None] * _LAYOUT.world
    dist.all_gather_object(out, state)
    return out[::_LAYOUT.model]


def my_state(state, ranks):
    """This data rank's entry of ``data_states``' list where the file has
    one for each data rank of this run, else ``state`` (rank 0's)."""
    if _LAYOUT is None or ranks is None or len(ranks) != _LAYOUT.data:
        return state
    return ranks[_LAYOUT.data_rank]


def data_parallel() -> bool:
    """Whether more than one rank shares the batch."""
    return _LAYOUT is not None and _LAYOUT.data > 1


def global_any(flag: bool) -> bool:
    """``flag`` OR-ed over every rank (medvill_tpu/core/mesh.py:228): an
    all-reduce MAX of one element; the local flag at world size 1."""
    if not multi_process():
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def rank_seed(seed: int) -> int:
    """A step's dropout seed on this data rank: ``seed`` itself on rank 0
    and without a layout; the ranks of one model group share it, so the
    replicated stream's masks (K3/K4, the plain dropouts) agree there."""
    if _LAYOUT is None or _LAYOUT.data_rank == 0:
        return seed
    return (seed + _LAYOUT.data_rank * SEED_STEP) % 2 ** 31


# ----------------------------------------------------------------- data axis

def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group (a new tensor, no gradient); ``t``
    without a layout."""
    if _LAYOUT is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_LAYOUT.data_group)
    return t


def batch_share(rows: int, device) -> torch.Tensor:
    """This rank's rows over the global batch's: the factor that turns a
    mean over the local rows into this rank's share of the global mean
    (1.0 exactly at one data rank).  For classification and retrieval,
    whose blocks (``local_rows``) may differ; the sharded loaders of
    pretrain and finetune give every rank as many rows, a share of 1/N."""
    local = torch.full((), float(rows), device=device)
    return local / data_sum(local)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's additive metrics (loss shares and counts) summed over the
    data group, in one collective."""
    if _LAYOUT is None or not metrics:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[n].detach().reshape(()).double()
                        for n in names])
    dist.all_reduce(flat, group=_LAYOUT.data_group)
    return {n: flat[i].to(metrics[n].dtype) for i, n in enumerate(names)}


def all_reduce_grads(grads: List[torch.Tensor]) -> None:
    """Sums gradients over the data group in place, one flat bucket per
    dtype (capturable: the bucket is made and read on the stream)."""
    if _LAYOUT is None or not grads:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=_LAYOUT.data_group)
        torch._foreach_copy_(same, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in same]), same)])


def data_parts(t: Optional[torch.Tensor]) -> list:
    """``t`` of every data rank, in data-rank order (``[None] * data`` for
    None; every rank of the group must call it alike)."""
    if t is None:
        return [None] * _LAYOUT.data
    parts = [torch.empty_like(t) for _ in range(_LAYOUT.data)]
    dist.all_gather(parts, t.contiguous(), group=_LAYOUT.data_group)
    return parts


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [B, ...] of every data rank, concatenated in rank order
    (no gradient; every rank holds the same B)."""
    if not data_parallel():
        return t.detach()
    out = t.new_empty((_LAYOUT.data * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.detach().contiguous(),
                                group=_LAYOUT.data_group)
    return out


def check_global_batch(size: int, flag: str) -> None:
    """Raises where the data ranks do not divide a global batch of
    ``size`` rows, as JAX's placement of a batch sharded over the data axis
    refuses it (a rank with no rows would average no loss)."""
    if _LAYOUT is not None and size % _LAYOUT.data:
        raise ValueError(f"{flag} {size} must be divisible by the "
                         f"{_LAYOUT.data} data ranks (the global batch is "
                         "split over them)")


def local_rows(batch: Dict) -> Dict:
    """The data rank's contiguous block of a global host batch (the
    classification and retrieval CLIs, where the batch is global as on
    JAX's mesh: GSPMD splits it over the data axis the same way; the CLIs
    hold it to ``check_global_batch``)."""
    if not data_parallel():
        return batch
    n = next(iter(batch.values())).shape[0]
    edges = [n * r // _LAYOUT.data for r in range(_LAYOUT.data + 1)]
    lo, hi = edges[_LAYOUT.data_rank], edges[_LAYOUT.data_rank + 1]
    return {k: v[lo:hi] for k, v in batch.items()}


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch: each rank's per-channel
    mean, sum of squared deviations and row count are gathered over the
    data group and combined (Chan et al.'s pairwise update, as precise as
    one rank's own two-pass statistics), and the backward's two
    reductions are summed over the group.  Autograd keeps x (its dtype)
    and the per-channel mean and inverse std, as ``native_batch_norm``
    does."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        acc = torch.promote_types(x.dtype, torch.float32)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        C = x.shape[1]
        xf = x.to(acc)
        var_r, mean_r = torch.var_mean(xf, dims, correction=0)
        n_r = float(x.numel() // C)
        local = torch.cat([mean_r, var_r * n_r,
                           torch.full((1,), n_r, device=x.device, dtype=acc)])
        every = local.new_empty(_LAYOUT.data * local.numel())
        dist.all_gather_into_tensor(every, local, group=_LAYOUT.data_group)
        every = every.view(_LAYOUT.data, -1)
        means, m2s, ns = every[:, :C], every[:, C:2 * C], every[:, 2 * C:]
        count = ns.sum()
        mean = (means * ns).sum(0) / count
        var = (m2s + ns * (means - mean) ** 2).sum(0) / count
        invstd = torch.rsqrt(var + eps)
        y = ((xf - mean.view(shape)) * (invstd * w.to(acc)).view(shape)
             + b.to(acc).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, w, mean, invstd, count)
        ctx.mark_non_differentiable(mean, invstd)
        return y, mean, invstd

    @staticmethod
    def backward(ctx, dy, _dmean, _dinvstd):
        x, w, mean, invstd, count = ctx.saved_tensors
        acc = mean.dtype
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        dyf = dy.to(acc)
        xhat = (x.to(acc) - mean.view(shape)) * invstd.view(shape)
        sums = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        local = sums.clone()
        dist.all_reduce(sums, group=_LAYOUT.data_group)
        C = x.shape[1]
        mean_dy = (sums[:C] / count).view(shape)
        mean_dy_xhat = (sums[C:] / count).view(shape)
        dx = ((dyf - mean_dy - xhat * mean_dy_xhat)
              * (invstd * w.to(acc)).view(shape)).to(x.dtype)
        # the parameter gradients stay this rank's share: the step sums
        # them over the data group with the others
        return dx, local[C:].to(w.dtype), local[:C].to(w.dtype), None


def sync_batch_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float):
    """(y in x's dtype, batch mean, inverse std) over the global batch."""
    return _SyncBatchNorm.apply(x, w, b, eps)


# ---------------------------------------------------------------- model axis

_COL = re.compile(r"(^|\.)layer\.\d+\.(attention\.self\.(query|key|value)"
                  r"|intermediate\.dense)\.(weight|bias)$")
_ROW = re.compile(r"(^|\.)layer\.\d+\.(attention\.)?output\.dense\.weight$")


def tp_spec(name: str, ndim: int) -> Optional[int]:
    """The dim of parameter ``name`` that the model axis shards, or None
    (replicated): medvill_tpu/core/mesh.py:85-122 on the port's names.
    torch ``Linear`` weights are [out, in], so column-parallel layers
    (``query``/``key``/``value``, ``intermediate.dense``) shard dim 0 of
    the weight and the bias, row-parallel ones (``attention.output.dense``
    and the FFN's ``output.dense``) dim 1 of the weight; their bias, the
    LayerNorms, embeddings, heads and the trunk are replicated."""
    if _COL.search(name) and ndim in (1, 2):
        return 0
    if _ROW.search(name) and ndim == 2:
        return 1
    return None


def tp_dims(model: torch.nn.Module, mp: int) -> Dict[str, int]:
    """{parameter name: sharded dim} of ``model`` under ``mp`` model ranks:
    ``tp_spec`` where the axis divides the dim (mesh.py:135-141)."""
    dims = {}
    for name, p in model.named_parameters():
        d = tp_spec(name, p.dim())
        if d is not None and mp > 1 and p.shape[d] % mp == 0:
            dims[name] = d
    return dims


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the model
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: sum over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def model_seed_add(add: int) -> int:
    """A kernel seed's per-call constant on this model rank: attention on
    local heads hashes local head indices, so each model rank folds its
    rank in (as JAX folds the shard index into the dropout key,
    medvill_tpu/ops/flash_attention.py:485-489)."""
    if _LAYOUT is None or _LAYOUT.model == 1:
        return add
    return (add + _LAYOUT.model_rank * SEED_STEP) & 0xFFFFFFFF


def _chunk(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.chunk(_LAYOUT.model, dim)[_LAYOUT.model_rank].clone()


def shard_state(state) -> Dict[str, int]:
    """Tensor-parallel placement of a ``TrainState`` (mesh.py::tp_shard):
    the parameters ``tp_dims`` names keep this model rank's slice, and so
    do their optimizer moments and gradients; the BERT modules that hold
    them get ``tp_group``.  Returns the dims (also ``model.tp_dims``)."""
    model = state.model
    dims = {} if _LAYOUT is None else tp_dims(model, _LAYOUT.model)
    model.tp_dims = dims
    if not dims:
        return dims
    params = dict(model.named_parameters())
    opt_state = state.tx.optimizer.state
    with torch.no_grad():
        for name, d in dims.items():
            p = params[name]
            for k, v in list(opt_state.get(p, {}).items()):
                if torch.is_tensor(v) and v.shape == p.shape:
                    opt_state[p][k] = _chunk(v, d)
            if p.grad is not None:
                p.grad = _chunk(p.grad, d)
            p.data = _chunk(p.data, d)
            p.tp_dim = d
    for name in dims:  # the module whose Linear holds the slice
        model.get_submodule(name.rsplit(".", 2)[0]).tp_group = \
            _LAYOUT.model_group
    return dims


def _gather_model(t: torch.Tensor, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(_LAYOUT.model)]
    dist.all_gather(parts, t.contiguous(), group=_LAYOUT.model_group)
    return torch.cat(parts, dim)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` on the CPU in the single-process layout (the
    model axis's slices gathered; every rank must call it)."""
    dims = getattr(model, "tp_dims", {})
    out = {}
    for k, v in model.state_dict().items():
        v = v.detach()
        if k in dims:
            v = _gather_model(v, dims[k])
        out[k] = v.to("cpu", copy=True)  # never a view of the live model
    return out


def full_param(p: torch.nn.Parameter, t: torch.Tensor) -> torch.Tensor:
    """A tensor shaped like parameter ``p`` (its moment, its gradient)
    gathered over the model axis where ``shard_state`` sliced ``p``."""
    d = getattr(p, "tp_dim", None)
    return t if d is None else _gather_model(t, d)


def load_full(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
              strict: bool = True):
    """``load_state_dict`` of a single-process state dict into a model
    placed by ``shard_state``."""
    dims = getattr(model, "tp_dims", {})
    return model.load_state_dict(
        {k: (_chunk(v, dims[k]) if k in dims else v) for k, v in sd.items()},
        strict=strict)


# -------------------------------------------------------------------- ZeRO-1

def place(state, zero1: bool = False) -> None:
    """Lays a ``TrainState`` whose model and optimizer state are whole (a
    fresh or restored one) out over the run's layout: ``shard_state``,
    then ``Zero1`` when asked (mesh.py:168-186: ZeRO-1 composes with the
    tensor-parallel slices), then ``WholeNorms`` where a tensor the
    optimizer updates lies over more than one rank.  Nothing without a
    layout."""
    if _LAYOUT is None:
        state.model.tp_dims = {}
        return
    shard_state(state)
    tx = state.tx
    params = [p for g in tx.optimizer.param_groups for p in g["params"]]
    if zero1:
        tx.zero1 = Zero1(tx.optimizer)
    sliced = [getattr(p, "tp_dim", None) is not None for p in params]
    spread = zero1 and _LAYOUT.data > 1
    if spread or any(sliced):
        local = ([p for g in tx.optimizer.param_groups for p in g["params"]]
                 if zero1 else params)
        whole = WholeNorms(tx.zero1.owner if zero1 else list(range(
            len(params))), local, sliced, spread, params[0].device)
        for g in tx.optimizer.param_groups:
            g["whole"] = whole


class WholeNorms:
    """The norms of whole tensors, for BertAdam's per-tensor clip, where the
    optimizer holds pieces of them: tensor-parallel slices (summed over the
    model group) and ZeRO-1's spans (summed over the data group).  JAX
    clips each GSPMD array by its global norm
    (medvill_tpu/train/optim.py:51-67); a piece's own norm would clip each
    piece by another factor.  ``owner[i]`` is the tensor (an index into the
    optimizer's parameters before ZeRO-1) of the i-th local piece,
    ``sliced[t]`` whether tensor t is a tensor-parallel slice."""

    def __init__(self, owner: List[int], local: List[torch.Tensor],
                 sliced: List[bool], spread: bool, device: torch.device):
        self.owner = {id(q): t for q, t in zip(local, owner)}
        self.count = len(sliced)
        self.spread = spread
        self.zero = torch.zeros((), device=device)
        self.sliced = (torch.tensor(sliced, device=device)
                       if any(sliced) else None)

    def norms(self, params: List[torch.Tensor],
              grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """The norm of the whole tensor of each of ``params`` (pieces this
        optimizer holds, with their ``grads``).  Every rank calls it at
        each update, whatever it holds."""
        sq = [self.zero] * self.count
        for q, n in zip(params, torch._foreach_norm(grads) if grads else []):
            sq[self.owner[id(q)]] = n * n  # one piece of a tensor per rank
        sq = torch.stack(sq)
        if self.spread:
            dist.all_reduce(sq, group=_LAYOUT.data_group)
        if self.sliced is not None:
            part = torch.where(self.sliced, sq, 0.0)
            dist.all_reduce(part, group=_LAYOUT.model_group)
            sq = torch.where(self.sliced, part, sq)
        whole = sq.sqrt()
        return (torch.stack([whole[self.owner[id(q)]] for q in params])
                if params else None)


class Zero1:
    """ZeRO-1 (mesh.py::zero1_shard) over an optimizer of train/optim.py
    (``AdamW`` or ``BertAdam``).  The optimizer's parameters are packed,
    in its order and each on a 512-byte boundary, into one flat buffer
    (zero-padded to N equal spans) and their gradients into another: each
    parameter and its ``.grad`` become views of them, so neither is held
    twice.  Data rank r owns span r.
    The optimizer itself is re-pointed at the pieces of its span (one per
    tensor that overlaps it, in that tensor's group), so decay groups and
    BertAdam's lr apply per element and the moments exist for the span
    alone; the state it had so far is cut into the pieces.  An update is
    the flat gradient reduce-scattered into the span, the optimizer's
    update of the pieces, and the span all-gathered into the flat
    parameters, both in place.  At one data rank the span is every
    tensor, flattened, and the update equals the replicated one."""

    def __init__(self, optimizer):
        lay = _LAYOUT
        self.n, self.r, self.group = lay.data, lay.data_rank, lay.data_group
        self.optimizer = optimizer
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        # each tensor starts on a 512-byte boundary, as the allocator
        # places a tensor of its own: kernels (cuBLAS's among them) pick
        # their paths by alignment, and the step must not change with it
        align = 512 // self.params[0].element_size()
        self.offsets, end = [], 0
        for p in self.params:
            self.offsets.append(end)
            end += -(-p.numel() // align) * align
        S = -(-end // self.n)
        lo, hi = self.r * S, (self.r + 1) * S
        first = self.params[0]
        self.flat = first.new_zeros(self.n * S)
        self.flat_grad = first.new_zeros(self.n * S)
        self.span = self.flat[lo:hi]
        self.span_grad = self.flat_grad[lo:hi]
        with torch.no_grad():
            for p, a in zip(self.params, self.offsets):
                view = self.flat[a:a + p.numel()]
                view.copy_(p.detach().reshape(-1))
                p.data = view.view_as(p)
                g = self.flat_grad[a:a + p.numel()].view_as(p)
                if p.grad is not None:
                    g.copy_(p.grad)
                p.grad = g
        # the pieces: (piece, its tensor, its start in the tensor)
        self.pieces = []
        groups, t = [], 0
        for g in optimizer.param_groups:
            mine = []
            for p in g["params"]:
                a = max(self.offsets[t], lo)
                b = min(self.offsets[t] + p.numel(), hi)
                if a < b:
                    q = torch.nn.Parameter(self.flat[a:b],
                                           requires_grad=p.requires_grad)
                    q.grad = self.flat_grad[a:b]
                    self.pieces.append((q, t, a - self.offsets[t]))
                    mine.append(q)
                t += 1
            groups.append(dict({k: v for k, v in g.items() if k != "params"},
                               params=mine))
        saved = [optimizer.state.get(p, {}) for p in self.params]
        optimizer.param_groups = groups
        optimizer.state = collections.defaultdict(dict)
        with torch.no_grad():
            for q, t, start in self.pieces:
                for k, v in saved[t].items():
                    if torch.is_tensor(v) and v.shape == self.params[t].shape:
                        v = v.reshape(-1)[start:start + q.numel()]
                    optimizer.state[q][k] = (v.clone() if torch.is_tensor(v)
                                             else v)
        if hasattr(optimizer, "_lr"):  # BertAdam's per-group device lr
            optimizer._lr = None

    @property
    def owner(self) -> List[int]:
        """The tensor of each piece, in the optimizer's order."""
        return [t for _, t, _ in self.pieces]

    def reduce_scatter(self) -> None:
        """The ranks' gradients summed into this rank's span (and the
        pieces trained where their tensors are: a classification phase
        freezes some)."""
        for q, t, _ in self.pieces:
            q.requires_grad_(self.params[t].requires_grad)
        dist.reduce_scatter_tensor(self.span_grad, self.flat_grad,
                                   group=self.group)

    def all_gather(self) -> None:
        """The ranks' updated spans into the flat parameters."""
        dist.all_gather_into_tensor(self.flat, self.span, group=self.group)

    def full_state(self) -> List[dict]:
        """Per parameter, its optimizer state with the moments whole
        (gathered over the data group; every data rank calls it alike).
        A rank may hold no piece of a tensor: which tensors have state, and
        their scalars (AdamW's step), come from the rank that does."""
        state = self.optimizer.state
        local = {}
        for q, t, _ in self.pieces:
            for k, v in state.get(q, {}).items():
                if not (torch.is_tensor(v) and v.shape == q.shape):
                    local.setdefault(t, {})[k] = (
                        v.detach().cpu() if torch.is_tensor(v) else v)
                else:
                    local.setdefault(t, {})[k] = None
        every = [None] * self.n
        dist.all_gather_object(every, local, group=self.group)
        known = {}
        for rows in every:
            for t, row in rows.items():
                known.setdefault(t, row)
        moments = sorted({k for row in known.values()
                          for k, v in row.items() if v is None})
        out = [dict(known.get(t, {})) for t in range(len(self.params))]
        for k in moments:
            buf = torch.zeros_like(self.flat)
            mine = torch.zeros_like(self.span)
            lo = self.r * self.span.numel()
            for q, t, start in self.pieces:
                if k in state.get(q, {}):
                    a = self.offsets[t] + start - lo
                    mine[a:a + q.numel()].copy_(state[q][k])
            dist.all_gather_into_tensor(buf, mine, group=self.group)
            for t, row in enumerate(out):
                if k in row:
                    p = self.params[t]
                    row[k] = buf[self.offsets[t]:self.offsets[t] + p.numel()
                                 ].view_as(p)
        return out
