"""CNN_BERT late-fusion baseline (the JAX package's ``CNNBert``,
medvill_tpu/models/cnn_bert.py:22-75; reference:
CNN_BERT/main_cnn_bert.py:124-195):

- ``ImgGlobalEncoder``: the ResNet-50 trunk and the mean over its fibers ->
  [B, 2048] (main_cnn_bert.py:124-136);
- ``TxtPooledEncoder``: BERT over ``[CLS] tokens [SEP] pad`` with the
  dense -10000 key bias of the first ``attn_len`` positions, then the
  pooler -> [B, hidden] (main_cnn_bert.py:138-177);
- ``CNNBert``: an f32 Linear over concat(image, text) -> 2 logits
  (main_cnn_bert.py:179-195).

Retrieval runs it as its non-CXRBERT branch.  It runs no attention kernel:
the text encoder takes ``mha_reference`` on the dense bias, as the JAX
package's does (it passes no ``attention_fn``).  Parameter names are the
reference checkpoint's (``core/torch_export.py::export_cnn_bert_state_dict``):
``txt_enc.txt_embeddings.* txt_enc.encoder.layer.* txt_enc.pooler.*
img_enc.model.{0,1,4..7}.* linear.*``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from medvill_torch.config import BertConfig
from medvill_torch.models.bert import (BertEmbeddings, BertEncoder,
                                       BertPooler, compute_dtype)
from medvill_torch.models.resnet import ResNet50Trunk, fibers
from medvill_torch.ops.dropout import DropoutRNG


class ImgGlobalEncoder(ResNet50Trunk):
    def forward(self, image: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 2048] in the compute dtype (the mean taken
        in f32, as jnp.mean does for bf16; f64 for f64).  ``train`` runs
        BatchNorm on batch statistics and updates the running ones."""
        f = fibers(super().forward(image, train=train))
        return f.to(torch.promote_types(f.dtype, torch.float32)).mean(1).to(
            self.dtype)


class TxtPooledEncoder(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.txt_embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)

    def forward(self, input_ids: torch.Tensor, attn_len: torch.Tensor,
                segment: torch.Tensor, deterministic: bool = True,
                attention_fn=None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """input_ids, segment [B, T]; attn_len [B] -> pooled [B, hidden]."""
        T = input_ids.shape[1]
        x = self.txt_embeddings(input_ids, token_type_ids=segment,
                                deterministic=deterministic, rng=rng)
        c = torch.arange(T, device=input_ids.device).view(1, 1, 1, T)
        bias = torch.where(c < attn_len.view(-1, 1, 1, 1), 0.0, -10000.0)
        hidden, _ = self.encoder(x, bias, attention_fn=attention_fn,
                                 deterministic=deterministic, rng=rng)
        return self.pooler(hidden)


class CNNBert(nn.Module):
    def __init__(self, config: BertConfig, n_classes: int = 2):
        super().__init__()
        self.config = config
        self.img_enc = ImgGlobalEncoder(dtype=compute_dtype(config))
        self.txt_enc = TxtPooledEncoder(config)
        self.linear = nn.Linear(self.img_enc.out_channels + config.hidden_size,
                                n_classes)

    def forward(self, input_ids: torch.Tensor, attn_len: torch.Tensor,
                segment: torch.Tensor, image: torch.Tensor,
                deterministic: bool = True, train_cnn: bool = False,
                attention_fn=None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Logits [B, n_classes] in the Linear's dtype (f32): both features
        are cast to f32 first, as in JAX."""
        img_vec = self.img_enc(image, train=train_cnn)
        txt_vec = self.txt_enc(input_ids, attn_len, segment,
                               deterministic=deterministic,
                               attention_fn=attention_fn, rng=rng)
        joint = torch.cat([img_vec.float(), txt_vec.float()], -1)
        return self.linear(joint.to(self.linear.weight.dtype))
