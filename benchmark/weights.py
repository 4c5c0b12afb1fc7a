"""The cell's weights, made on the device from the run's seed.

Every tensor of the model's ``param_spec`` (``reference/<model>.py``) is
drawn in one call:
one ``randn`` over all the drawn tensors from a ``torch.Generator`` on the
device, split and scaled (linear and embedding weights by the
configuration's ``initializer_range``, convolutions by ``1 / sqrt(fan
in)``), and the LayerNorm and BatchNorm tensors set to their identity.
The same seed on the same device gives the same tensors, so the reference
makes them again after the program's run instead of keeping a copy.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import models


def make(model: str, dims: dict, seed: int,
         device) -> Dict[str, torch.Tensor]:
    spec = models.load(model).param_spec(dims)
    drawn = [(n, s, d) for n, s, d in spec if d in ("normal", "conv")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, draw in drawn:
        n = math.prod(shape)
        scale = (dims["initializer_range"] if draw == "normal"
                 else 1.0 / math.sqrt(math.prod(shape[1:])))
        out[name] = flat[at:at + n].view(shape).mul_(scale)
        at += n
    for name, shape, draw in spec:
        if draw == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif draw == "ones":
            out[name] = torch.ones(shape, device=device)
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module,
              weights: Dict[str, torch.Tensor]) -> None:
    """Copies ``weights`` into the program's model by name: every
    parameter (a tied one under its first name) and every floating buffer
    it has must be given, and every tensor given must be used."""
    used = set()
    for name, t in list(model.named_parameters()) + [
            (n, b) for n, b in model.named_buffers() if b.is_floating_point()]:
        if name not in weights:
            raise KeyError(f"the benchmark makes no tensor for {name}")
        if tuple(weights[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: the benchmark's shape "
                             f"{tuple(weights[name].shape)}, the program's "
                             f"{tuple(t.shape)}")
        t.copy_(weights[name])
        used.add(name)
    unused = set(weights) - used
    if unused:
        raise KeyError(f"the program has no tensor for {sorted(unused)[:5]}")
