"""Dropout with explicit generators, and the kernels' seeds.

``DropoutRNG(seed, device)`` holds the randomness of training forwards on
one device.  Its ``generator`` lives on the device and draws the Bernoulli
masks of the plain dropouts (embeddings, hidden states,
``mha_reference``'s attention probabilities); ``next_seed()`` hands each
kernel call (the attention kernel K1, the fused-LN kernel K3) a fresh
``DeviceSeed``: the kernel reads ``base[0]``, a one-element int32 tensor
on the device, and adds the call's constant ``add`` (``i * GOLDEN`` for
the i-th call since the last ``reseed``), which a CUDA graph captures as
it stands.  ``reseed(seed)`` writes a step's seed into ``base`` and
reseeds the generator, outside any graph; a training run keeps one
``DropoutRNG`` and reseeds it before every micro-step, so a graph's
replay after a ``reseed`` draws the masks an eager step from that seed
draws (register ``generator`` with the graph).  No device value is read
back to make a seed.

A kernel's keep mask is a pure function of its seed (ops/fused_ln.py,
ops/flash_attention.py); ``seed_value`` gives the seed of either form as
what the plain versions compute with, so a ``DeviceSeed`` whose base holds
s and whose add is 0 gives the masks of the int s.

The JAX package's dropout bits come from ``jax.random`` and the TPU PRNG,
which nothing here reproduces; the two packages agree only at rate 0.
``BertConfig.fast_dropout`` (keep iff raw uint32 bits >= floor(rate*2^32))
has the same Bernoulli(1 - rate) keep marginal as ``nn.Dropout``, so the
port has this one dropout for both.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # 2^32 / golden ratio: the step between a step's seeds


class DeviceSeed(NamedTuple):
    """The seed ``(base[0] + add) mod 2**32``: ``base`` a one-element int32
    tensor on the kernel's device, ``add`` a uint32 constant."""

    base: torch.Tensor
    add: int


Seed = Union[int, DeviceSeed]


def seed_value(seed: Seed):
    """The uint32 seed as an int (host seed) or an int64 0-dim tensor on
    the base's device (``DeviceSeed``; no read back to the host)."""
    if isinstance(seed, DeviceSeed):
        return (seed.base.reshape(()).long() + seed.add) & M32
    return int(seed) & M32


def seed_args(seed: Seed, device: torch.device) -> tuple:
    """(pointer or None, uint32) for a kernel's seed arguments: the kernel
    adds the second to the uint32 at the pointer, when there is one."""
    if isinstance(seed, DeviceSeed):
        b = seed.base
        if b.dtype != torch.int32 or b.numel() != 1 or b.device != device:
            raise TypeError(f"a device seed is one int32 on {device}, got "
                            f"{b.dtype}{tuple(b.shape)} on {b.device}")
        return b.data_ptr(), seed.add & M32
    return None, int(seed) & M32


class DropoutRNG:
    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.generator = torch.Generator(device=device)
        self.base = torch.zeros(1, dtype=torch.int32, device=device)
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        """A step's start (outside any graph): ``seed`` into ``base`` and
        the generator, the kernel calls counted from 0."""
        self.base.fill_(int(seed))
        self.generator.manual_seed(int(seed))
        self.calls = 0

    def next_seed(self) -> DeviceSeed:
        self.calls += 1
        return DeviceSeed(self.base, (self.calls * GOLDEN) & M32)


def dropout(x: torch.Tensor, rate: float, rng: DropoutRNG) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``; the output keeps x's dtype."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.generator,
                      device=x.device) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=x.dtype, device=x.device))
