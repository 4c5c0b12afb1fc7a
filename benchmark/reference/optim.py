"""The two optimizers, written plainly.

- ``AdamW`` (pretraining): bias-corrected moments, ``eps`` added to the
  corrected root, weight decay decoupled (``p *= 1 - lr * wd`` first).
- ``BertAdam`` (report generation, ``pytorch_pretrained_bert``'s, as the
  finetune script builds it): each tensor's gradient clipped to norm
  ``max_grad_norm`` (``g * min(1, max / (||g|| + 1e-6))``), moments with no
  bias correction, the update ``m / (sqrt(v) + eps) + wd * p`` (``wd`` for
  the decay group only) scaled by ``-lr * warmup_linear(k / t_total)`` for
  the k-th update, k from 0.  A parameter that no loss reaches takes a zero
  gradient.

``first_moment`` is each parameter's first moment, the state the
benchmark compares after the first dispatch.
"""
from __future__ import annotations

from typing import List

import torch


def warmup_linear(x: float, warmup: float) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0),
                                             0.0)


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, weight_decay: float):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
        self.t = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.sqrt() / c2 ** 0.5 + self.eps
            p.sub_(self.lr / c1 * m / denom)

    def first_moment(self) -> List[torch.Tensor]:
        return self.m


class BertAdam:
    def __init__(self, params: List[torch.Tensor], decay: List[bool],
                 lr: float, t_total: int, warmup: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 max_grad_norm: float = 1.0):
        self.params, self.decay = params, decay
        self.lr, self.t_total, self.warmup = lr, t_total, warmup
        self.wd = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.max_grad_norm = max_grad_norm
        self.k = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        scale = -self.lr * warmup_linear(self.k / self.t_total, self.warmup)
        for p, g, m, v, dec in zip(self.params, grads, self.m, self.v,
                                   self.decay):
            g = g * min(1.0, self.max_grad_norm
                        / (g.norm().item() + 1e-6))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = m / (v.sqrt() + self.eps)
            if dec and self.wd > 0:
                u = u + self.wd * p
            p.add_(u * scale)
        self.k += 1

    def first_moment(self) -> List[torch.Tensor]:
        return self.m
