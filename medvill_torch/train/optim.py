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
"""
from __future__ import annotations

import math
from typing import Iterable, List

import torch
from torch import nn


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
        for group, lr in zip(self.param_groups, self._lr):
            params = [p for p in group["params"] if p.requires_grad]
            if not params:
                continue
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self.max_grad_norm > 0:
                norms = torch.stack(torch._foreach_norm(grads))
                clip = torch.clamp(self.max_grad_norm / (norms + 1e-6),
                                   max=1.0)
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
            torch._foreach_mul_(update, lr)
            torch._foreach_add_(params, update)


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

    def applies_next(self) -> bool:
        """Whether the next ``step()`` applies the update."""
        return self.count + 1 >= self.every

    def prepare(self) -> None:
        self.optimizer.prepare()

    @torch.no_grad()
    def apply_device(self) -> None:
        grads = [p.grad for group in self.optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
        if self.every > 1 and grads:
            torch._foreach_div_(grads, float(self.every))
        self.optimizer.device_step()
        if self.keep_grads:
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
