"""The optimizer of the pretraining step (medvill_tpu/train/optim.py:46-48,
219-230,268-295).

- ``adamw``: ``torch.optim.AdamW`` is ``optax.adamw`` here: bias-corrected
  moments, eps added outside the square root, weight decay decoupled from
  the gradient (torch scales the parameter by ``1 - lr * wd`` before the
  Adam step; optax adds ``lr * wd * p`` to the update: the same sum).
- ``trainable``: the whole-trunk freeze (``masked_trainable`` +
  ``stop_frozen`` in JAX): frozen parameters (``requires_grad=False``) are
  not handed to the optimizer, so neither the update nor weight decay
  moves them, and the frozen trunk's forward runs under ``torch.no_grad()``
  (models/joint.py), so no backward is built for it.
- ``Accumulate``: gradient accumulation as ``optax.MultiSteps`` does it: the
  mean of ``every`` micro-batch gradients, applied once; the parameters do
  not move on the other micro-steps, and the Adam step count advances once
  per application.
"""
from __future__ import annotations

from typing import Iterable, List

import torch
from torch import nn


def adamw(params: Iterable[nn.Parameter], lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-6,
          weight_decay: float = 0.0) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def trainable(model: nn.Module) -> List[nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


class Accumulate:
    """Call ``step()`` after each micro-batch's ``backward()`` (which sums
    into ``.grad``).  Every ``every``-th call divides the sums by ``every``,
    steps the optimizer and clears the gradients; it returns whether it
    applied."""

    def __init__(self, optimizer: torch.optim.Optimizer, every: int):
        self.optimizer = optimizer
        self.every = max(1, int(every))
        self.count = 0

    def step(self) -> bool:
        self.count += 1
        if self.count < self.every:
            return False
        if self.every > 1:
            with torch.no_grad():
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(self.every)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.count = 0
        return True
