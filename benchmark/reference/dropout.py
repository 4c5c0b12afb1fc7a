"""The training step's randomness, worked out from the host generator that
both sides are handed.

Each micro-step draws, from the host ``torch.Generator`` in this order:
the random-pixel indices (pretraining only: ``sort(randperm(M)[:N])``,
one draw shared by the batch) and the dropout seed ``s`` (``randint(0,
2**31)``).  With ``s``:

- the plain dropouts (the embeddings' outputs) keep an element iff
  ``torch.rand`` from a device generator seeded with ``s``, drawn in the
  forward's order at the tensor's shape, is at least the rate;
- the i-th fused call of the step (from 1: per layer the attention, then
  the attention output's dropout-add-LayerNorm, then the FFN output's)
  has the seed ``(s + i * 0x9E3779B9) mod 2**32``, and keeps an element
  iff ``fmix32(seed ^ index) >= floor(rate * 2**32)`` in uint32
  arithmetic, where ``index`` is the element's row-major position:
  ``((b * heads + h) * L + r) * L + c`` for the attention probabilities,
  ``row * H + col`` over the ``[B * L, H]`` rows of a dropout-add-LN.

A kept element is scaled by ``1 / (1 - rate)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def host_draws(generator: torch.Generator, num_fibers: Optional[int],
               num_embeds: Optional[int]) -> Tuple[Optional[torch.Tensor],
                                                   int]:
    """(pixel indices or None, dropout seed) of one micro-step."""
    pix = None
    if num_fibers is not None:
        perm = torch.randperm(num_fibers, generator=generator)
        pix = torch.sort(perm[:num_embeds]).values
    seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
    return pix, seed


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h < 2**32, by 16-bit halves of c so
    that no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 values below 2**32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hashed_keep(seed: int, shape, rate: float, device) -> torch.Tensor:
    """Bool keep mask of ``shape`` by the hash of each element's row-major
    index, built a slab at a time so that the int64 temporaries stay
    small."""
    n = 1
    for d in shape:
        n *= d
    threshold = int(rate * 2 ** 32)
    out = torch.empty(n, dtype=torch.bool, device=device)
    step = 1 << 24
    for start in range(0, n, step):
        idx = torch.arange(start, min(n, start + step), dtype=torch.int64,
                           device=device) & M32
        out[start:start + step] = fmix32(idx ^ (seed & M32)) >= threshold
    return out.view(*shape)


class StepRandomness:
    """The dropout of one micro-step (see the module docstring)."""

    def __init__(self, seed: int, rate_hidden: float, rate_attn: float,
                 device):
        self.seed = seed
        self.rate_hidden, self.rate_attn = rate_hidden, rate_attn
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.calls = 0

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """An embedding output's dropout."""
        rate = self.rate_hidden
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= rate
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)

    def _next(self) -> int:
        self.calls += 1
        return (self.seed + self.calls * GOLDEN) & M32

    def attention(self, probs: torch.Tensor) -> torch.Tensor:
        """probs [B, heads, L, L]."""
        rate = self.rate_attn
        keep = hashed_keep(self._next(), probs.shape, rate, probs.device)
        return torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, H] before a residual add and LayerNorm."""
        rate = self.rate_hidden
        B, L, H = x.shape
        keep = hashed_keep(self._next(), (B * L, H), rate,
                           x.device).view(B, L, H)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)
