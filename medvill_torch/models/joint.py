"""Single-stream joint encoder: ``[CLS] img(N) [SEP] txt`` -> BERT (the
JAX package's ``JointEncoder``, medvill_tpu/models/joint.py:56-185).

- The ResNet-50 trunk emits fiber features; ``pixel_indices`` selects
  ``num_image_embeds`` of them (random-pixel sampling, one sorted draw per
  step shared by the batch) and doubles as their position ids.
- Image tokens share the text position/token-type tables and the
  embedding LayerNorm and dropout (reference: ImageBertEmbeddings).
- [CLS] and [SEP] are embedded as 1-token sequences, so both sit at
  position 0.
- NONCROSS ("disturbing") inserts a text-CLS (type 1, position 0) after
  [SEP], and the CLS representation is the elementwise product of positions
  0 and ``img_block``.
- With a kernel ``attention_fn`` the spec is the mask and no ``[B, 1, L,
  L]`` bias is built; without one, the bias comes from ``bias_from_spec``.
- A frozen trunk (``ImageEncoderConfig.freeze_prefix_stages``, the
  reference's whole-trunk freeze) runs under ``torch.no_grad()``; in
  training its BatchNorm statistics still update (models/resnet.py).
- The ViT encoder (``encoder="ViT"``) replaces the trunk by
  ``ImagePatchEmbedding``: p x p patches, each projected to
  ``img_hidden_size``; its tokens take positions ``arange(M)``, draw no
  pixels and are never frozen.

Parameter names follow ``export_cxrbert_state_dict``'s ``enc.*`` layout:
``txt_embeddings.*``, ``img_embeddings.img_embeddings.*``,
``img_encoder.model.*`` (ViT: ``img_encoder.patch_to_embedding.*``),
``encoder.layer.*``, ``pooler.*``.  The pooled image encoders run in the
classification model only (models/mmbt.py).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from medvill_torch.config import BertConfig, ImageEncoderConfig
from medvill_torch.data.masks import MaskGeometry, bias_from_spec
from medvill_torch.models.bert import (BertEmbeddings, BertEncoder,
                                       BertPooler, compute_dtype, dense)
from medvill_torch.models.resnet import (ResNet50Trunk, device_normalize,
                                         fibers)
from medvill_torch.ops.dropout import DropoutRNG

PORTED_ENCODERS = ("random-pixel", "full-fiber", "ViT")


class ImagePatchEmbedding(nn.Module):
    """ViT-style patch embedding (medvill_tpu/models/joint.py:34-53;
    reference: models/image.py:95-110): uint8 or float NHWC images ->
    [B, (H/p)(W/p), dim].  Patches come row-major and each flattens as
    (row in patch, column in patch, channel), the reference's einops
    ``b c (h p1) (w p2) -> b (h w) (p1 p2 c)``; the projection runs in
    f32, as JAX's ``Dense`` does on its f32 input."""

    def __init__(self, patch_size: int, dim: int = 2048, channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.patch_to_embedding = nn.Linear(patch_size * patch_size
                                            * channels, dim)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = device_normalize(image)
        B, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // p) * (W // p), p * p * C)
        return self.patch_to_embedding(
            x.to(self.patch_to_embedding.weight.dtype))


class JointEncoder(nn.Module):
    def __init__(self, config: BertConfig, image: ImageEncoderConfig,
                 img_position: bool = True):
        super().__init__()
        if image.encoder not in PORTED_ENCODERS:
            raise NotImplementedError(
                f"image encoder {image.encoder!r} is not ported; the port "
                f"runs {PORTED_ENCODERS}")
        self.config = config
        self.image = image
        self.img_position = img_position
        self.dtype = compute_dtype(config)
        self.txt_embeddings = BertEmbeddings(config)
        self.vit = image.encoder == "ViT"
        patches = (image.img_size // image.patch_size) ** 2
        if self.vit and image.num_image_embeds != patches:
            raise ValueError(
                f"the ViT encoder at {image.img_size} px, patch "
                f"{image.patch_size}, gives {patches} image tokens, not "
                f"num_image_embeds {image.num_image_embeds}")
        if self.vit:
            self.img_encoder = ImagePatchEmbedding(image.patch_size,
                                                   image.img_hidden_size)
        else:
            self.img_encoder = ResNet50Trunk(dtype=self.dtype)
        self.img_embeddings = nn.ModuleDict({"img_embeddings": nn.Linear(
            image.img_hidden_size if self.vit
            else self.img_encoder.out_channels, config.hidden_size)})
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)
        if image.freeze_prefix_stages and not self.vit:
            self.img_encoder.requires_grad_(False)

    def encode_image(self, image: torch.Tensor,
                     pixel_indices: Optional[torch.Tensor],
                     train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image [B, H, W, 3] -> (features [B, N, 2048], positions
        [B, N]).  ViT: every patch, ``pixel_indices`` ignored."""
        if self.vit:
            feats = self.img_encoder(image)
            B, M, _ = feats.shape
            return feats, torch.arange(M, device=feats.device).expand(B, -1)
        frozen = self.image.freeze_prefix_stages
        with torch.no_grad() if frozen else contextlib.nullcontext():
            feats = fibers(self.img_encoder(image, train=train))
        B, M, _ = feats.shape
        pos = torch.arange(M, device=feats.device)
        if pixel_indices is not None:
            feats = feats[:, pixel_indices]
            pos = pixel_indices.to(feats.device)
        return feats, pos.expand(B, -1)

    def embed_image_tokens(self, feats: torch.Tensor,
                           positions: torch.Tensor, deterministic: bool,
                           rng: Optional[DropoutRNG]) -> torch.Tensor:
        """Projection + shared position/type embeddings (type 0) + shared
        LayerNorm and dropout."""
        emb = self.txt_embeddings
        x = dense(self.img_embeddings["img_embeddings"], feats,
                  self.dtype).float()
        if self.img_position:
            x = x + emb.position_embeddings(positions)
        x = x + emb.token_type_embeddings(torch.zeros_like(positions))
        return emb.norm_and_drop(x, deterministic, rng)

    def forward(self, cls_tok: torch.Tensor, input_txt: torch.Tensor,
                mask_spec: torch.Tensor, segment: torch.Tensor,
                image: torch.Tensor, sep_tok: torch.Tensor,
                pixel_indices: Optional[torch.Tensor] = None,
                deterministic: bool = True, train_cnn: bool = False,
                disturbing: bool = False, attention_fn=None,
                rng: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sequence [B, L, hidden], pooled or the NONCROSS CLS
        representation [B, hidden]).  cls_tok/sep_tok [B, 1]; input_txt and
        segment [B, seq_len + 1]; mask_spec [B, 2] (variant, txt_len)."""
        geom = MaskGeometry(self.image.num_image_embeds,
                            input_txt.shape[1] - 1, extra_text_cls=disturbing)
        emb = self.txt_embeddings
        feats, img_pos = self.encode_image(image, pixel_indices,
                                           train=train_cnn)
        img_embed = self.embed_image_tokens(feats, img_pos, deterministic,
                                            rng)
        zeros1 = torch.zeros_like(cls_tok)
        kw = dict(deterministic=deterministic, rng=rng)
        parts = [emb(cls_tok, token_type_ids=zeros1, **kw), img_embed,
                 emb(sep_tok, token_type_ids=zeros1, **kw)]
        if disturbing:
            parts.append(emb(cls_tok, token_type_ids=zeros1 + 1, **kw))
        parts.append(emb(input_txt, token_type_ids=segment, **kw))
        bias = (None if attention_fn is not None
                else bias_from_spec(mask_spec, geom))
        hidden, _ = self.encoder(torch.cat(parts, dim=1), bias,
                                 attention_fn=attention_fn, **kw)
        if disturbing:
            return hidden, hidden[:, 0] * hidden[:, geom.img_block]
        return hidden, self.pooler(hidden)
