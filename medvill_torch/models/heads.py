"""MLM head (the JAX package's ``MLMHead``, medvill_tpu/models/heads.py:
23-59): dense -> f32 erf-GELU -> LayerNorm (eps 1e-5, output in the compute
dtype) -> optional ``relax_projection`` select by ``task_idx`` -> decoder
tied to the word embeddings, with compute-dtype operands, f32 logits and a
free ``bias``.

Parameter names follow the reference's ``cls.predictions.*``:
``transform.dense``, ``transform.LayerNorm``, ``decoder.weight`` (the shared
word-embedding table, as torch's tied ``state_dict`` writes it) and
``bias``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from medvill_torch.config import BertConfig
from medvill_torch.models.bert import dense, layer_norm


class _Transform(nn.Module):
    def __init__(self, cfg: BertConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, width)
        self.LayerNorm = nn.LayerNorm(width, eps=1e-5)


class _TiedDecoder(nn.Module):
    """Holds the shared word-embedding Parameter under ``weight``.  Not an
    ``nn.Linear``, so casting the matmul weights to the compute dtype leaves
    the f32 embedding table alone."""

    def __init__(self, weight: nn.Parameter):
        super().__init__()
        self.weight = weight


class MLMHead(nn.Module):
    def __init__(self, cfg: BertConfig, word_embeddings: nn.Embedding):
        super().__init__()
        self.cfg = cfg
        self.relax = cfg.relax_projection if cfg.relax_projection > 1 else 1
        self.transform = _Transform(cfg, cfg.hidden_size * self.relax)
        self.decoder = _TiedDecoder(word_embeddings.weight)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden: torch.Tensor,
                task_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hidden [B, L, H] in the compute dtype -> f32 logits [B, L, V]."""
        dt = hidden.dtype
        x = F.gelu(dense(self.transform.dense, hidden, dt).float())
        x = layer_norm(self.transform.LayerNorm, x, dt)
        if self.relax > 1:
            B, L = x.shape[:2]
            x = x.view(B, L, self.relax, self.cfg.hidden_size)
            if task_idx is None:
                task_idx = torch.zeros(B, dtype=torch.long, device=x.device)
            idx = task_idx.long().view(B, 1, 1, 1).expand(
                B, L, 1, self.cfg.hidden_size)
            x = torch.gather(x, 2, idx)[:, :, 0]
        # compute-dtype operands, f32 products and sums: the exact
        # upcast of both operands followed by an f32 matmul
        w = self.decoder.weight.to(dt).float()
        return torch.matmul(x.float(), w.t()) + self.bias
