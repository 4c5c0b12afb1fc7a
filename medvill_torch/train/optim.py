"""The optimizers of the pretraining and finetune steps
(medvill_tpu/train/optim.py:25-109,219-230,268-295 and
train/finetune.py:199-208).

- ``adamw``: ``torch.optim.AdamW`` is ``optax.adamw`` here: bias-corrected
  moments, eps added outside the square root, weight decay decoupled from
  the gradient (torch scales the parameter by ``1 - lr * wd`` before the
  Adam step; optax adds ``lr * wd * p`` to the update: the same sum).  On
  a CUDA device it is ``capturable``: its step count lives on the device,
  so a CUDA graph can capture its update (torch takes ``capturable`` on
  CUDA parameters only; on the CPU it is off).
- ``trainable``: the whole-trunk freeze (``masked_trainable`` +
  ``stop_frozen`` in JAX): frozen parameters (``requires_grad=False``) are
  not handed to the optimizer, so neither the update nor weight decay
  moves them, and the frozen trunk's forward runs under ``torch.no_grad()``
  (models/joint.py), so no backward is built for it.
- ``Accumulate``: gradient accumulation as ``optax.MultiSteps`` does it: the
  mean of ``every`` micro-batch gradients, applied once; the parameters do
  not move on the other micro-steps, and the Adam step count advances once
  per application.  An application is three parts, so that a CUDA graph
  can capture the device part alone (train/dispatch.py): ``prepare`` (the
  host writes what the update reads: BertAdam's lr), ``apply_device``
  (divide, update, clear the gradients) and ``finish`` (the host's
  counters).  With ``keep_grads`` the gradients are zeroed in place, not
  freed, so the ``.grad`` buffers keep the addresses a graph captured.
- ``BertAdam``: the vendored BertAdam as ``make_finetune_tx`` builds it,
  applied to the accumulated mean gradient: each tensor's gradient clipped
  by ``min(1, max_grad_norm / (||g|| + 1e-6))``, Adam without bias
  correction (``m / (sqrt(v) + eps)``), ``weight_decay * p`` added where
  ``decay_groups`` decays, all scaled by ``-lr * schedule(k / t_total,
  warmup)`` for the k-th update (k from 0, so the first update has lr 0).
  A trainable parameter with no gradient (the pooler, whose output no
  finetune loss reads) takes a zero one, as JAX's zero cotangent: weight
  decay still moves it.  A parameter with ``requires_grad`` off (a
  classification phase's frozen trunk or text encoder) is skipped: no
  update, no decay, its moments untouched (zero while it has never
  trained), as JAX's frozen-phase step zeroes its updates.  ``plateau``
  multiplies the lr on top of the schedule (the classification CLI's
  ``ReduceLROnPlateau`` scale, train/classify.py).  The lr reaches the
  update as a device scalar, ``-lr * schedule * plateau``, written by
  ``prepare`` before each update (a captured update reads the value of
  its replay, not the one of its capture).
- ``SCHEDULES``: ``warmup_linear`` (decays as ``max((x - 1) / (warmup -
  1), 0)``), ``warmup_constant``, ``warmup_cosine``
  (reference: sc/pytorch_pretrained_bert/optimization.py:32-44).
- ``Accumulate.state_dict`` / ``load_state_dict``: the whole optimizer
  state as CPU tensors and Python values (per parameter in
  ``param_groups`` order: AdamW's moments and step, BertAdam's moments;
  BertAdam's ``opt_step`` and ``plateau``; ``count``; the gradients summed
  so far when a run stops mid-accumulation: JAX saves ``MultiSteps``'
  ``acc_grads``), so a state saved after micro-step n and loaded gives the
  next micro-step of the run that never stopped.  The load copies into the
  tensors that already exist (the moments, the ``.grad`` buffers that
  ``keep_grads`` keeps and a CUDA graph reads) and makes the others on
  each parameter's device, AdamW's step on the device when ``capturable``;
  so a file written on the card loads on the CPU and the other way round.
  BertAdam's device lr is written from the restored ``opt_step`` by the
  next ``prepare``.
"""
from __future__ import annotations

import math
from typing import Iterable, List

import torch
from torch import nn

from medvill_torch import parallel


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` with ``Accumulate``'s three parts; all of its
    state is on the device, so ``prepare`` and ``finish`` have nothing to
    do."""

    def prepare(self) -> None:
        pass

    def device_step(self) -> None:
        self.step()

    def finish(self) -> None:
        pass

    def host_state(self) -> dict:
        return {}

    def load_host_state(self, host: dict) -> None:
        pass


def adamw(params: Iterable[nn.Parameter], lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-6,
          weight_decay: float = 0.0) -> AdamW:
    params = list(params)
    capturable = bool(params) and all(p.is_cuda for p in params)
    return AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                 weight_decay=weight_decay, capturable=capturable)


def trainable(model: nn.Module) -> List[nn.Parameter]:
    """Each trainable parameter once (a tied table is listed once)."""
    return [p for p in model.parameters() if p.requires_grad]


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


SCHEDULES = {
    "warmup_linear": warmup_linear,
    "warmup_constant": warmup_constant,
    "warmup_cosine": warmup_cosine,
}


def decay_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """The trainable parameters in two groups: decayed, and exempt (every
    LayerNorm/BatchNorm parameter and every Linear's bias: JAX's
    ``no_decay_mask`` over the flax names ``bias``, ``scale`` and
    ``*LayerNorm*``; reference finetune.py:383-390).
    The MLM head's free vocabulary bias is flax's ``decoder_bias``, which
    that mask decays, and decays here too."""
    exempt = set()
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
            exempt.update(id(p) for p in m.parameters(recurse=False))
        elif isinstance(m, nn.Linear) and m.bias is not None:
            exempt.add(id(m.bias))
    params = trainable(model)
    return [{"params": [p for p in params if id(p) not in exempt],
             "weight_decay": weight_decay},
            {"params": [p for p in params if id(p) in exempt],
             "weight_decay": 0.0}]


class BertAdam(torch.optim.Optimizer):
    """See the module docstring.  ``param_groups`` carry their own
    ``weight_decay`` (``decay_groups``); the moments live in
    ``state[p]["m"]``/``["v"]`` and ``opt_step`` counts the updates."""

    def __init__(self, params, lr: float, t_total: int, warmup: float = 0.1,
                 schedule: str = "warmup_linear", b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        self.t_total = max(1, int(t_total))
        self.warmup = warmup
        self.schedule = SCHEDULES[schedule]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.opt_step = 0
        self.plateau = 1.0
        self._lr = None  # per group, -lr * lr_scale() on the device

    def lr_scale(self) -> float:
        """``schedule(opt_step / t_total, warmup) * plateau`` of the next
        update."""
        return (self.schedule(self.opt_step / self.t_total, self.warmup)
                * self.plateau)

    def prepare(self) -> None:
        """Writes the next update's ``-lr * lr_scale()`` to the device."""
        if self._lr is None:
            device = self.param_groups[0]["params"][0].device
            self._lr = [torch.zeros((), device=device)
                        for _ in self.param_groups]
        scale = self.lr_scale()
        for group, lr in zip(self.param_groups, self._lr):
            lr.fill_(-group["lr"] * scale)

    def finish(self) -> None:
        self.opt_step += 1

    def host_state(self) -> dict:
        return {"opt_step": self.opt_step, "plateau": self.plateau}

    def load_host_state(self, host: dict) -> None:
        self.opt_step = int(host["opt_step"])
        self.plateau = float(host["plateau"])

    def step(self, closure=None):
        self.prepare()
        self.device_step()
        self.finish()

    @torch.no_grad()
    def device_step(self) -> None:
        """The update, reading only device state (capturable once the
        moments exist).  Named as torch names an optimizer's step, so a
        profile shows its span (tools/torch_pretrain_profile.py)."""
        with torch.profiler.record_function("Optimizer.step#BertAdam.step"):
            self._update()

    def _update(self) -> None:
        live = [[p for p in group["params"] if p.requires_grad]
                for group in self.param_groups]
        params = [p for ps in live for p in ps]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.max_grad_norm > 0:
            # where the tensors lie over several ranks (parallel.place),
            # each piece is clipped by its whole tensor's norm; every rank
            # takes part in that sum, whatever it holds
            whole = self.param_groups[0].get("whole")
            norms = (whole.norms(params, grads) if whole is not None else
                     torch.stack(torch._foreach_norm(grads)) if grads
                     else None)
            if norms is not None and grads:
                clip = torch.clamp(self.max_grad_norm / (norms + 1e-6),
                                   max=1.0)
                grads = torch._foreach_mul(grads, list(clip.unbind(0)))
        i = 0
        for group, lr, ps in zip(self.param_groups, self._lr, live):
            if not ps:
                continue
            gs, i = grads[i:i + len(ps)], i + len(ps)
            for p in ps:
                if not self.state[p]:
                    self.state[p]["m"] = torch.zeros_like(p)
                    self.state[p]["v"] = torch.zeros_like(p)
            m = [self.state[p]["m"] for p in ps]
            v = [self.state[p]["v"] for p in ps]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, gs, alpha=1.0 - self.b1)
            torch._foreach_mul_(v, self.b2)
            torch._foreach_addcmul_(v, gs, gs, value=1.0 - self.b2)
            update = torch._foreach_sqrt(v)
            torch._foreach_add_(update, self.eps)
            update = torch._foreach_div(m, update)
            if group["weight_decay"] > 0:
                torch._foreach_add_(update, ps, alpha=group["weight_decay"])
            torch._foreach_mul_(update, lr)
            torch._foreach_add_(ps, update)


class Accumulate:
    """Call ``step()`` after each micro-batch's ``backward()`` (which sums
    into ``.grad``).  Every ``every``-th call divides the sums by ``every``,
    steps the optimizer and clears the gradients; it returns whether it
    applied.  ``optimizer`` is a ``BertAdam`` or an ``AdamW`` of this
    module."""

    def __init__(self, optimizer, every: int):
        self.optimizer = optimizer
        self.every = max(1, int(every))
        self.count = 0
        self.keep_grads = False
        self.zero1 = None  # parallel.Zero1, set by parallel.place

    def applies_next(self) -> bool:
        """Whether the next ``step()`` applies the update."""
        return self.count + 1 >= self.every

    def prepare(self) -> None:
        self.optimizer.prepare()

    @torch.no_grad()
    def apply_device(self) -> None:
        if self.zero1 is None:
            grads = [p.grad for p in self.params() if p.grad is not None]
            # data parallelism: the ranks' gradients summed
            parallel.all_reduce_grads(grads)
        else:
            self.zero1.reduce_scatter()
            grads = [self.zero1.span_grad]
        if self.every > 1 and grads:
            torch._foreach_div_(grads, float(self.every))
        self.optimizer.device_step()
        if self.zero1 is not None:
            self.zero1.all_gather()
            # the parameters' .grad are views of one buffer: kept, zeroed
            self.zero1.flat_grad.zero_()
        elif self.keep_grads:
            if grads:
                torch._foreach_zero_(grads)
        else:
            self.optimizer.zero_grad(set_to_none=True)

    def finish(self, applied: bool) -> None:
        """The host's counters after a micro-step."""
        if applied:
            self.optimizer.finish()
            self.count = 0
        else:
            self.count += 1

    def step(self) -> bool:
        applied = self.applies_next()
        if applied:
            self.prepare()
            self.apply_device()
        self.finish(applied)
        return applied

    def params(self) -> List[nn.Parameter]:
        """The parameters the optimizer updates, whole (not ZeRO-1's
        pieces; tensor-parallel slices as the model holds them)."""
        if self.zero1 is not None:
            return self.zero1.params
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def full_state(self) -> List[dict]:
        """Per parameter of ``params()``, its optimizer state as one process
        would hold it: ZeRO-1's spans gathered over the data ranks and
        tensor-parallel slices over the model ranks (every rank calls it
        alike).  Empty for a parameter not updated yet."""
        params = self.params()
        rows = (self.zero1.full_state() if self.zero1 is not None
                else [self.optimizer.state.get(p, {}) for p in params])
        return [{k: (parallel.full_param(p, v) if torch.is_tensor(v)
                     and v.dim() and v.shape == p.shape else v)
                 for k, v in row.items()} for p, row in zip(params, rows)]

    def state_dict(self) -> dict:
        """See the module docstring; ``grads`` is None at a count of 0.
        Under scale-out it is the single-process state of the global run
        (``full_state``, the ranks' gradients summed), and every rank must
        call it."""
        params = self.params()

        def cpu(v):
            return v.detach().cpu() if torch.is_tensor(v) else v

        def whole(p, g):
            return None if g is None else cpu(parallel.full_param(p, g))

        out = {
            "optimizer": type(self.optimizer).__name__,
            "state": [{k: cpu(v) for k, v in row.items()}
                      for row in self.full_state()],
            "host": self.optimizer.host_state(),
            "count": self.count,
            "grads": [whole(p, None if p.grad is None else
                            parallel.data_sum(p.grad)) for p in params]
            if self.count else None}
        if self.count and parallel.data_parallel():
            # each data rank's own sum so far, so that a resume at this
            # layout sums the same terms in the same order
            out["grads_ranks"] = [
                [whole(p, g) for p, g in zip(params, gs)]
                for gs in zip(*[parallel.data_parts(p.grad) for p in params])]
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """``state_dict``'s output into this optimizer, in place where a
        tensor exists (see the module docstring); raises ValueError on
        another optimizer, parameter count or shape."""
        opt, params = self.optimizer, self.params()
        if self.zero1 is not None:
            raise ValueError("load the state before ZeRO-1 shards it "
                             "(parallel.place)")
        if sd["optimizer"] != type(opt).__name__ \
                or len(sd["state"]) != len(params):
            raise ValueError(
                f"optimizer state of {sd['optimizer']} over "
                f"{len(sd['state'])} parameters, not of "
                f"{type(opt).__name__} over {len(params)}")
        on_device = {id(p): g.get("capturable", False) or g.get("fused", False)
                     for g in opt.param_groups for p in g["params"]}
        grads = sd["grads"] or [None] * len(params)
        mine = parallel.my_state(None, sd.get("grads_ranks"))
        if mine is not None:
            grads = mine
        elif parallel.layout() is not None and parallel.layout().data_rank:
            # the file holds the ranks' summed gradients: one rank of the
            # data group takes them, so the next sum gives them once
            grads = [None if g is None else torch.zeros_like(g)
                     for g in grads]
        for p, saved, g in zip(params, sd["state"], grads):
            live = opt.state[p]
            if not saved:
                live.clear()  # a parameter the saved run never updated
            for k, v in saved.items():
                if not torch.is_tensor(v):
                    live[k] = v
                    continue
                if v.dim() and v.shape != p.shape:
                    raise ValueError(f"optimizer state {k} of shape "
                                     f"{tuple(v.shape)} for a parameter of "
                                     f"{tuple(p.shape)}")
                if k in live and live[k].shape == v.shape:
                    live[k].copy_(v)
                elif k == "step":
                    live[k] = v.to(torch.float32, copy=True).to(
                        p.device if on_device[id(p)] else "cpu")
                else:
                    live[k] = v.to(p.device, p.dtype, copy=True)
            if g is not None and g.shape != p.shape:
                raise ValueError(f"a gradient of shape {tuple(g.shape)} for "
                                 f"a parameter of {tuple(p.shape)}")
            if g is None:
                if p.grad is not None and self.keep_grads:
                    p.grad.zero_()
                else:
                    p.grad = None
            elif p.grad is not None:
                p.grad.copy_(g)
            else:
                p.grad = g.to(p.device, p.dtype, copy=True)
        opt.load_host_state(sd["host"])
        self.count = int(sd["count"])
