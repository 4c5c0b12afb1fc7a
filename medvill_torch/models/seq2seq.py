"""UniLM-style report-generation model, decode entry points only
(medvill_tpu/models/seq2seq.py:71-185,229-269).

Semantics kept from the JAX package:

- the image segment is ``[CLS word-emb, Linear(2048->H) fibers, SEP
  word-emb]`` with positions ``[0, i for fiber i, N+1]`` -- fiber i gets
  position i, overlapping CLS at 0 -- and the segment's token types (4 under
  new_segment_ids);
- ``decode_logits`` projects the LAST window row only;
- per-layer K/V caches, written in place at ``cache_index``.

``VLPForPreTraining`` subclasses ``VLPEncoder`` instead of holding it as
``bert``, so the parameter names are the reference finetune checkpoint's
unprefixed ``txt_embeddings.* img_embeddings.img_embeddings.*
img_encoder.model.* encoder.layer.* pooler.* cls.predictions.*``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from medvill_torch.config import BertConfig, ImageEncoderConfig
from medvill_torch.models.bert import (BertEmbeddings, BertEncoder,
                                       BertPooler, KVCache, compute_dtype,
                                       dense, layer_norm)
from medvill_torch.models.heads import MLMHead
from medvill_torch.models.resnet import ResNet50Trunk, fibers


class VLPEncoder(nn.Module):
    """Image-aware BERT with the ``[CLS] img(N) [SEP] txt...`` layout."""

    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 len_vis_input: int = 256):
        super().__init__()
        self.config = config
        self.image = image
        self.len_vis_input = len_vis_input
        self.dtype = compute_dtype(config)
        self.txt_embeddings = BertEmbeddings(config)
        self.img_encoder = ResNet50Trunk(dtype=self.dtype)
        self.img_embeddings = nn.ModuleDict({"img_embeddings": nn.Linear(
            self.img_encoder.out_channels, config.hidden_size)})
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)

    def encode_image(self, image: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = fibers(self.img_encoder(image))
        B, M, _ = feats.shape
        pos = torch.arange(M, device=feats.device).expand(B, M)
        # the reference assumes fiber count == len_vis_input (256 at 512 px)
        return feats[:, :self.len_vis_input], pos[:, :self.len_vis_input]

    def embed_image_segment(self, input_ids_seg: torch.Tensor,
                            feats: torch.Tensor, vis_pe: torch.Tensor,
                            token_type_ids: torch.Tensor) -> torch.Tensor:
        """input_ids_seg [B, N+2]: only its first ([CLS]) and last ([SEP])
        ids are used."""
        emb = self.txt_embeddings
        B = feats.shape[0]
        img_emb = dense(self.img_embeddings["img_embeddings"], feats,
                        self.dtype)
        tokens = torch.cat(
            [emb.word_embeddings(input_ids_seg[:, :1]).to(img_emb.dtype),
             img_emb,
             emb.word_embeddings(input_ids_seg[:, -1:]).to(img_emb.dtype)],
            dim=1)
        pos_ids = torch.cat(
            [torch.zeros(B, 1, dtype=torch.long, device=feats.device),
             vis_pe.long(),
             torch.full((B, 1), self.len_vis_input + 1, dtype=torch.long,
                        device=feats.device)], dim=1)
        x = (tokens.float() + emb.position_embeddings(pos_ids)
             + emb.token_type_embeddings(token_type_ids))
        return layer_norm(emb.LayerNorm, x, self.dtype)

    def prefill(self, image: torch.Tensor, input_ids_seg: torch.Tensor,
                token_type_ids_seg: torch.Tensor, kv_caches: List[KVCache],
                bias: torch.Tensor):
        """Encode the image segment, writing K/V at [0, N+2).  Returns
        (hidden_seg, caches)."""
        feats, vis_pe = self.encode_image(image)
        x = self.embed_image_segment(input_ids_seg, feats, vis_pe,
                                     token_type_ids_seg)
        return self.encoder(x, bias, kv_caches=kv_caches, cache_index=0)

    def decode_window(self, token_ids: torch.Tensor,
                      position_ids: torch.Tensor,
                      token_type_ids: torch.Tensor, kv_caches: List[KVCache],
                      cache_index: int, bias: torch.Tensor):
        """A W-position text window (committed token + [MASK] probe) against
        the cache.  bias: [B or 1, 1, W, L_cache]."""
        x = self.txt_embeddings(token_ids, token_type_ids=token_type_ids,
                                position_ids=position_ids)
        return self.encoder(x, bias, kv_caches=kv_caches,
                            cache_index=cache_index)

    def init_kv_caches(self, batch: int, max_len: int,
                       device) -> List[KVCache]:
        cfg = self.config
        shape = (batch, max_len, cfg.num_attention_heads, cfg.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=device),
                 torch.zeros(shape, dtype=self.dtype, device=device))
                for _ in range(cfg.num_hidden_layers)]


class VLPForPreTraining(VLPEncoder):
    """VLPEncoder + the tied MLM head (report generation)."""

    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 len_vis_input: int = 256):
        super().__init__(config, image, len_vis_input)
        self.cls = nn.ModuleDict({"predictions": MLMHead(
            config, self.txt_embeddings.word_embeddings)})

    def decode_prefill(self, image, input_ids_seg, token_type_ids_seg,
                       kv_caches, bias):
        return self.prefill(image, input_ids_seg, token_type_ids_seg,
                            kv_caches, bias)

    def decode_step(self, token_ids, position_ids, token_type_ids,
                    kv_caches, cache_index, bias, task_idx=None):
        hidden, new_caches = self.decode_window(
            token_ids, position_ids, token_type_ids, kv_caches, cache_index,
            bias)
        return self.decode_logits(hidden, task_idx=task_idx), new_caches

    def decode_logits(self, hidden: torch.Tensor,
                      task_idx: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """f32 MLM logits of the LAST window position: [B, V].  Decode is
        the s2s pipeline: task_idx 3 under relax_projection
        (sc/data_loader.py:464)."""
        if task_idx is None and self.config.relax_projection > 1:
            task_idx = torch.full((hidden.shape[0],), 3, dtype=torch.long,
                                  device=hidden.device)
        return self.cls["predictions"](hidden[:, -1:], task_idx)[:, 0]

    def prepare_for_compute(self) -> "VLPForPreTraining":
        """Store every Linear and Conv2d weight in the compute dtype once, so
        the per-call casts are no-ops.  Numerically the same as casting at
        each call; LayerNorm, BatchNorm and the (tied) embedding tables stay
        f32.  Call after loading weights."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(self.dtype)
        return self


def init_weights(model: nn.Module, seed: int,
                 initializer_range: float = 0.02) -> None:
    """Random weights from ``seed``, shaped like the JAX init: Linear and
    Embedding weights ~ N(0, initializer_range) with zero biases,
    convolutions ~ N(0, 1/fan_in) (lecun), LayerNorm/BatchNorm at their
    identity defaults."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, initializer_range, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
