"""UniLM-style finetune model for report generation and VQA, and its
decode entry points (medvill_tpu/models/seq2seq.py:71-269).

Semantics kept from the JAX package:

- the image segment is ``[CLS word-emb, Linear(2048->H) fibers, SEP
  word-emb]`` with positions ``[0, i for fiber i, N+1]`` -- fiber i gets
  position i, overlapping CLS at 0 -- and the segment's token types (4 under
  new_segment_ids), through the shared embedding LayerNorm and dropout;
- the training forward's text positions restart at 0 (the vendored
  BertEmbeddings default), while decode uses its own window positions: a
  reference train/decode inconsistency kept for parity (JAX
  seq2seq.py:12-16);
- a frozen trunk (``ImageEncoderConfig.freeze_prefix_stages``, the
  reference's whole-trunk freeze) runs under ``torch.no_grad()``; with
  ``train_cnn`` its BatchNorm uses batch statistics and updates the running
  ones (models/resnet.py), as in pretraining;
- report generation gathers ``masked_pos`` before the tied MLM head (with
  ``task_idx`` under relax_projection); VQA classifies ``h[:, 0]`` in
  training and ``h[:, 0] * h[:, len_vis + 1]`` at inference;
- ``decode_logits`` projects the LAST window row only; per-layer K/V
  caches are written in place at ``cache_index``.

``VLPForPreTraining`` subclasses ``VLPEncoder`` instead of holding it as
``bert``, so the parameter names are the reference finetune checkpoint's
unprefixed ``txt_embeddings.* img_embeddings.img_embeddings.*
img_encoder.model.* encoder.layer.* pooler.*`` and ``cls.predictions.*``
(``ans_classifier.*`` for VQA).
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from medvill_torch.config import BertConfig, ImageEncoderConfig
from medvill_torch.models.bert import (BertEmbeddings, BertEncoder,
                                       BertPooler, KVCache, compute_dtype,
                                       dense)
from medvill_torch.models.heads import MLMHead, VQAHead
from medvill_torch.models.resnet import ResNet50Trunk, fibers
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.utils import tracing


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
        if image.freeze_prefix_stages:
            self.img_encoder.requires_grad_(False)

    def encode_image(self, image: torch.Tensor, train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        frozen = self.image.freeze_prefix_stages
        with torch.no_grad() if frozen else contextlib.nullcontext():
            feats = fibers(self.img_encoder(image, train=train))
        tracing.mark("image")
        B, M, _ = feats.shape
        pos = torch.arange(M, device=feats.device).expand(B, M)
        # the reference assumes fiber count == len_vis_input (256 at 512 px)
        return feats[:, :self.len_vis_input], pos[:, :self.len_vis_input]

    def embed_image_segment(self, input_ids_seg: torch.Tensor,
                            feats: torch.Tensor, vis_pe: torch.Tensor,
                            token_type_ids: torch.Tensor,
                            deterministic: bool = True,
                            rng: Optional[DropoutRNG] = None
                            ) -> torch.Tensor:
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
        return emb.norm_and_drop(x, deterministic, rng)

    def forward(self, image: torch.Tensor, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                deterministic: bool = True, train_cnn: bool = False,
                attention_fn=None, rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: (sequence [B, L, H], pooled [B, H]).
        input_ids and token_type_ids [B, L] hold the image segment's N + 2
        slots first; the mask is ``bias`` [B, 1, L, L] or, with
        ``attention_fn``, the spec the kernel closes over."""
        N2 = self.len_vis_input + 2
        feats, vis_pe = self.encode_image(image, train=train_cnn)
        kw = dict(deterministic=deterministic, rng=rng)
        img_embed = self.embed_image_segment(
            input_ids[:, :N2], feats, vis_pe, token_type_ids[:, :N2], **kw)
        txt_embed = self.txt_embeddings(
            input_ids[:, N2:], token_type_ids=token_type_ids[:, N2:], **kw)
        hidden, _ = self.encoder(torch.cat([img_embed, txt_embed], dim=1),
                                 bias, attention_fn=attention_fn, **kw)
        return hidden, self.pooler(hidden)

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
    """VLPEncoder + the tied MLM head (report generation and decode) or,
    with ``task`` "vqa", the answer classifier instead: the parameters of
    the JAX model, whose VQA forward never builds the MLM head."""

    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 len_vis_input: int = 256, task: str = "report_generation",
                 n_answers: int = 458):
        super().__init__(config, image, len_vis_input)
        self.task = task
        if task == "vqa":
            self.ans_classifier = VQAHead(config.hidden_size, n_answers)
        else:
            self.cls = nn.ModuleDict({"predictions": MLMHead(
                config, self.txt_embeddings.word_embeddings)})

    def forward(self, image: torch.Tensor, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                masked_pos: Optional[torch.Tensor] = None,
                deterministic: bool = True, train_cnn: bool = False,
                attention_fn=None, vqa_inference: bool = False,
                task_idx: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """f32 logits: VQA [B, n_answers]; report generation the MLM logits
        of the gathered ``masked_pos`` [B, P, V]."""
        sequence, _ = super().forward(
            image, input_ids, token_type_ids, bias,
            deterministic=deterministic, train_cnn=train_cnn,
            attention_fn=attention_fn, rng=rng)
        if self.task == "vqa":
            embed = sequence[:, 0]
            if vqa_inference:  # CLS * the image segment's SEP
                embed = embed * sequence[:, self.len_vis_input + 1]
            return self.ans_classifier(embed)
        gathered = torch.take_along_dim(
            sequence, masked_pos.long().unsqueeze(-1), dim=1)
        return self.cls["predictions"](gathered, task_idx)

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
