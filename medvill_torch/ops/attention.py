"""Multi-head attention with an additive bias (the JAX package's
``mha_reference``, medvill_tpu/ops/attention.py:23-48).

Shapes: q, k, v are [B, L, heads, D]; bias is [B or 1, 1, Lq, Lk] additive
(``(1 - mask) * -10000``, never -inf).  Both products take their operands in
the input dtype and accumulate and return in f32, as JAX's
``preferred_element_type=f32`` does: the operands are upcast exactly and
multiplied in f32, so callers must keep TF32 off for a reference comparison.
The softmax is f32 and the probabilities are cast to V's dtype before P.V.

This is deliberately not ``scaled_dot_product_attention``: the JAX package
computes this outside any kernel, and the decode masks must stay the same
-10000 biases bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v -> [B, Lq, heads, D] in v's dtype.

    Inference only: attention-probability dropout is a training feature
    that the port does not have yet."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(v.dtype)
