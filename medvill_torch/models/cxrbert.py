"""CXRBERT: the joint encoder with the tied MLM head and the ITM head (the
JAX package's ``CXRBERT``, medvill_tpu/models/cxrbert.py:21-83).

The training step uses ``features`` (sequence and pooled output, no head
projection), ``mlm_chunk`` (the MLM head over a slice of positions, so the
[B, L, vocab] logits are never built) and ``itm_logits``; retrieval uses
``itm_forward`` (the pooled output through the ITM head, no MLM logits).  Parameter names
are the reference's pretrain ``state_dict`` (``export_cxrbert_state_dict``):
``enc.*``, ``mlm.predictions.*`` (decoder tied to
``enc.txt_embeddings.word_embeddings.weight``) and ``itm.linear.*``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from medvill_torch.config import BertConfig, ImageEncoderConfig
from medvill_torch.models.heads import ITMHead, MLMHead
from medvill_torch.models.joint import JointEncoder


class CXRBERT(nn.Module):
    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 img_position: bool = True):
        super().__init__()
        self.config = config
        self.enc = JointEncoder(config, image, img_position=img_position)
        self.mlm = nn.ModuleDict({"predictions": MLMHead(
            config, self.enc.txt_embeddings.word_embeddings)})
        self.itm = ITMHead(config.hidden_size)

    def features(self, *args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sequence, pooled): ``JointEncoder.forward``'s arguments."""
        return self.enc(*args, **kwargs)

    def mlm_chunk(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied MLM head over positions [B, C, H] -> f32 [B, C, V]."""
        return self.mlm["predictions"](hidden)

    def itm_logits(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.itm(pooled)

    def itm_forward(self, *args, **kwargs) -> torch.Tensor:
        """Alignment logits only, f32 [B, 2]: the retrieval forward
        (medvill_tpu/models/cxrbert.py:71-83; reference:
        Downstream_task/Retrieval/retrieval.py:12-32 keeps enc + itm).
        ``JointEncoder.forward``'s arguments."""
        _, pooled = self.enc(*args, **kwargs)
        return self.itm(pooled)
