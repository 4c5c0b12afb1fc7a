"""MMBT multilabel classification model (the counterpart of
medvill_tpu/models/mmbt.py; reference:
Downstream_task/Classification/mmbt/models/mmbt.py:7-114).

What differs from the pretrain joint encoder (models/joint.py):

- the image segment ``[CLS] img(N) [SEP]`` takes positions ``arange(N+2)``
  (not the pretrain path's position-0 trick) and token type 0; [CLS] and
  [SEP] are word embeddings cast to the compute dtype beside the projected
  image features, then the shared position/type tables, the embedding
  LayerNorm and dropout are applied to the whole segment;
- the text segment is embedded on its own with positions from 0 and its
  segment ids (1);
- attention is the 1-D padding mask broadcast over rows: the FULL spec
  ``(FULL, txt_len)`` over ``L = N + 2 + T`` (a dense -10000 bias without
  an ``attention_fn``);
- the image encoder is the ResNet-50 trunk with the full-fiber features
  (the first N fibers), ``pool`` (the 1-9-embed adaptive-pool table) or
  ``pool-half`` (any other encoder name takes the fibers, as in JAX);
- ``MultimodalBertClf`` adds ``clf``, one f32 Linear on the pooled output
  (the reference encoder's unused inner ``clf`` is not built).

Parameter names follow ``export_mmbt_state_dict``: ``enc.txt_embeddings.*``,
``enc.img_embeddings.img_embeddings.*``, ``enc.img_encoder.model.*``,
``enc.encoder.layer.*``, ``enc.pooler.*``, ``clf.*``; the shared ``enc.*``
names are those of the pretrain checkpoint (models/cxrbert.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from medvill_torch.config import BertConfig, ImageEncoderConfig, MaskVariant
from medvill_torch.data.masks import MaskGeometry, bias_from_spec
from medvill_torch.models.bert import (BertEmbeddings, BertEncoder,
                                       BertPooler, compute_dtype, dense)
from medvill_torch.models.heads import ClfHead
from medvill_torch.models.resnet import (ResNet50Trunk, fibers,
                                         half_pooled_fibers, pooled_fibers)
from medvill_torch.ops.dropout import DropoutRNG


def full_spec(txt_len: torch.Tensor) -> torch.Tensor:
    """[B] valid text positions -> the [B, 2] int32 spec (FULL, txt_len)."""
    return torch.stack([torch.full_like(txt_len, int(MaskVariant.FULL)),
                        txt_len], dim=-1).to(torch.int32).contiguous()


class MultimodalBertEncoder(nn.Module):
    def __init__(self, config: BertConfig, image: ImageEncoderConfig):
        super().__init__()
        self.config = config
        self.image = image
        self.dtype = compute_dtype(config)
        self.txt_embeddings = BertEmbeddings(config)
        self.img_encoder = ResNet50Trunk(dtype=self.dtype)
        self.img_embeddings = nn.ModuleDict({"img_embeddings": nn.Linear(
            self.img_encoder.out_channels, config.hidden_size)})
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)

    def image_features(self, image: torch.Tensor,
                       train_cnn: bool = False) -> torch.Tensor:
        """[B, H, W, 3] -> [B, N, 2048] by the configured encoder."""
        fmap = self.img_encoder(image, train=train_cnn)
        N = self.image.num_image_embeds
        if self.image.encoder == "pool":
            return pooled_fibers(fmap, N, self.image.pool_type)
        if self.image.encoder == "pool-half":
            return half_pooled_fibers(fmap, self.image.pool_type)[:, :N]
        return fibers(fmap)[:, :N]

    def forward(self, input_txt: torch.Tensor, txt_len: torch.Tensor,
                segment: torch.Tensor, image: torch.Tensor, cls_id: int,
                sep_id: int, deterministic: bool = True,
                train_cnn: bool = False, attention_fn=None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """input_txt, segment [B, T]; txt_len [B]; image [B, H, W, 3].
        ``train_cnn`` runs the trunk's BatchNorm on batch statistics and
        updates the running ones.  Returns the pooled output [B, hidden]
        in the compute dtype."""
        B, T = input_txt.shape
        N = self.image.num_image_embeds
        emb = self.txt_embeddings
        img_vecs = dense(self.img_embeddings["img_embeddings"],
                         self.image_features(image, train_cnn), self.dtype)
        # (cls_id, sep_id) made on the device: no host copy in a captured step
        ids = cls_id + (sep_id - cls_id) * torch.arange(
            2, device=input_txt.device)
        cls_emb, sep_emb = emb.word_embeddings(ids).to(img_vecs.dtype)
        hid = img_vecs.shape[-1]
        tokens = torch.cat([cls_emb.expand(B, 1, hid), img_vecs,
                            sep_emb.expand(B, 1, hid)], dim=1)
        pos = torch.arange(N + 2, device=input_txt.device)
        x = (tokens.float() + emb.position_embeddings(pos)
             + emb.token_type_embeddings(torch.zeros_like(pos)))
        kw = dict(deterministic=deterministic, rng=rng)
        img_embed = emb.norm_and_drop(x, **kw)
        txt_embed = emb(input_txt, token_type_ids=segment, **kw)
        bias = None
        if attention_fn is None:
            bias = bias_from_spec(full_spec(txt_len),
                                  MaskGeometry(N, T - 1))
        hidden, _ = self.encoder(torch.cat([img_embed, txt_embed], dim=1),
                                 bias, attention_fn=attention_fn, **kw)
        return self.pooler(hidden)


class MultimodalBertClf(nn.Module):
    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 n_classes: int):
        super().__init__()
        self.config = config
        self.enc = MultimodalBertEncoder(config, image)
        self.clf = ClfHead(config.hidden_size, n_classes)

    def forward(self, input_txt, txt_len, segment, image, cls_id: int,
                sep_id: int, deterministic: bool = True,
                train_cnn: bool = False, attention_fn=None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """f32 logits [B, n_classes]."""
        return self.clf(self.enc(input_txt, txt_len, segment, image, cls_id,
                                 sep_id, deterministic=deterministic,
                                 train_cnn=train_cnn,
                                 attention_fn=attention_fn, rng=rng))
