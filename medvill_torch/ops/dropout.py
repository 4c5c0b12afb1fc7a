"""Dropout with explicit generators.

``DropoutRNG`` holds the randomness of one training forward, made from one
seed: ``generator`` lives on the compute device and draws the Bernoulli
masks of the plain dropouts (embeddings, hidden states, ``mha_reference``'s
attention probabilities), and ``next_seed()`` hands each kernel call (the
attention kernel K1, the fused-LN kernel K3) a fresh 31-bit seed from a
host generator, so no device value is read back to make one.

The JAX package's dropout bits come from ``jax.random`` and the TPU PRNG,
which nothing here reproduces; the two packages agree only at rate 0.
``BertConfig.fast_dropout`` (keep iff raw uint32 bits >= floor(rate*2^32))
has the same Bernoulli(1 - rate) keep marginal as ``nn.Dropout``, so the
port has this one dropout for both.
"""
from __future__ import annotations

import torch


class DropoutRNG:
    def __init__(self, seed: int, device):
        device = torch.device(device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))
        self._host = torch.Generator()
        self._host.manual_seed(int(seed))

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31, (), generator=self._host))


def dropout(x: torch.Tensor, rate: float, rng: DropoutRNG) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)``; the output keeps x's dtype."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=rng.generator,
                      device=x.device) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=x.dtype, device=x.device))
