"""The reference run of a training cell's first micro-steps.

``follow`` starts from the benchmark's weights, draws each micro-step's
randomness from a host generator seeded as the program's was, computes the
loss and its gradient over the trainable parameters, sums the gradients
over ``accumulation`` micro-steps, divides by it and steps its optimizer.
It returns what the comparison reads (``Readings``): every micro-step's
loss, each parameter's first-moment norm after micro-step ``k`` (one
dispatch), the norm of each parameter's first mean gradient, and the norm
of each parameter's change over all the micro-steps.  Two knobs plant
faults for the control: ``rows`` < the batch runs every step on its first
rows only, and ``grad_scale`` multiplies each mean gradient (4/3: the sum
divided by 3 where it takes 4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import models
from benchmark.reference.dropout import StepRandomness, host_draws
from benchmark.reference.optim import AdamW, BertAdam
from benchmark.reference.precision import Products, tf32_off


@dataclasses.dataclass
class Readings:
    losses: List[float]
    moment_norms: Dict[str, float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def _optimizer(opt: dict, names: List[str], params: List[torch.Tensor]):
    if opt["name"] == "adamw":
        return AdamW(params, opt["lr"], opt["beta1"], opt["beta2"],
                     opt["eps"], opt["weight_decay"])
    if opt["name"] == "bertadam":
        return BertAdam(params, [models.decayed(n) for n in names],
                        opt["lr"], opt["t_total"], opt["warmup"],
                        opt["weight_decay"])
    raise ValueError(f"unknown optimizer {opt['name']!r}")


def follow(model: str, dims: dict, opt: dict,
           weights: Dict[str, torch.Tensor], batches: List[dict],
           draw_seed: int, accumulation: int, k: int,
           precision: str = "f32", rows: Optional[int] = None,
           device="cuda", grad_scale: float = 1.0) -> Readings:
    tf32_off()
    prod = Products(precision)
    P = {n: w.detach().to(device, torch.float32).clone()
         for n, w in weights.items()}
    ref = models.load(model)
    names = [n for n, _, _ in ref.param_spec(dims) if ref.trainable(n)]
    for n in names:
        P[n].requires_grad_(True)
    params = [P[n] for n in names]
    start = [p.detach().clone() for p in params]
    optimizer = _optimizer(opt, names, params)
    generator = torch.Generator().manual_seed(draw_seed)
    pixels = ref.pixels(dims)
    loss_fn = ref.loss
    acc = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    moments: Dict[str, float] = {}
    grads1: Dict[str, float] = {}
    for i, host in enumerate(batches):
        pix, seed = host_draws(generator, pixels, dims["num_image_embeds"])
        batch = {n: torch.as_tensor(np.asarray(v)[:rows]).to(device)
                 for n, v in host.items()}
        rnd = StepRandomness(seed, dims["hidden_dropout_prob"],
                             dims["attention_probs_dropout_prob"], device)
        loss = loss_fn(P, batch, pix, rnd, dims, prod)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
        losses.append(float(loss.detach()))
        del loss, grads
        if (i + 1) % accumulation == 0:
            mean = [a * (grad_scale / accumulation) for a in acc]
            if not grads1:
                grads1 = {n: float(g.norm()) for n, g in zip(names, mean)}
            optimizer.step(mean)
            for a in acc:
                a.zero_()
        if i + 1 == k:
            moments = {n: float(m.norm()) for n, m in
                       zip(names, optimizer.first_moment())}
    change = {n: float((p.detach() - s).norm())
              for n, p, s in zip(names, params, start)}
    return Readings(losses, moments, grads1, change)
