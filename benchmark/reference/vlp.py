"""The report-generation model (VLP): unprefixed names, the MLM head
under ``cls.predictions.``.

``loss``: the image segment ``[CLS] fibers [SEP]`` at positions ``0,
0..N-1, N+1`` and the text at positions from 0, the MLM head on the
masked positions, label smoothing (``models.label_smoothing``), the
weighted sum over the batch divided by the weights' sum + 1e-5
(``sc/finetune.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import masks
from benchmark.reference.dropout import StepRandomness
from benchmark.reference.models import (Spec, embed, encoder, joint_spec,
                                       label_smoothing, layer_norm,
                                       mlm_logits, trunk_fibers)
from benchmark.reference.precision import Products

TRUNK = "img_encoder.model."


def param_spec(dims: dict) -> Spec:
    return joint_spec("", TRUNK, "cls.predictions.", dims)


def trainable(name: str) -> bool:
    """The trunk is frozen; its BatchNorm statistics are not parameters."""
    return not name.startswith(TRUNK)


def pixels(dims: dict):
    """No draw: every fiber is an image token."""
    return None


def loss(P, batch: Dict[str, torch.Tensor], pix: Optional[torch.Tensor],
         rnd: StepRandomness, dims: dict, prod: Products) -> torch.Tensor:
    del pix  # every fiber is an image token
    eps = dims["layer_norm_eps"]
    ids = batch["input_ids"].long()
    seg = batch["segment_ids"].long()
    dev = ids.device
    B, L = ids.shape
    with torch.no_grad():
        fibers = trunk_fibers(P, TRUNK, batch["image"], prod)
    N = dims["num_image_embeds"]
    fibers = fibers[:, :N]
    N2 = N + 2
    e = "txt_embeddings."
    word = P[e + "word_embeddings.weight"]
    img = prod.linear(fibers, P["img_embeddings.img_embeddings.weight"],
                      P["img_embeddings.img_embeddings.bias"])
    tokens = torch.cat([prod.act(word[ids[:, :1]]), img,
                        prod.act(word[ids[:, N2 - 1:N2]])], dim=1)
    pos = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                     torch.arange(N, device=dev),
                     torch.full((1,), N + 1, dtype=torch.long, device=dev)])
    x = (tokens + P[e + "position_embeddings.weight"][pos]
         + P[e + "token_type_embeddings.weight"][seg[:, :N2]])
    img_seg = rnd.plain(layer_norm(x, P[e + "LayerNorm.weight"],
                                   P[e + "LayerNorm.bias"], eps, prod))
    txt = embed(P, "", ids[:, N2:], seg[:, N2:],
                 torch.arange(L - N2, device=dev).expand(B, L - N2), eps,
                 rnd, prod)
    bias = masks.additive_bias("seq2seq", batch["mask_spec"], L, N2)
    h = encoder(P, "", torch.cat([img_seg, txt], dim=1), bias, dims, rnd,
                prod)
    pos_m = batch["masked_pos"].long()
    g = torch.gather(h, 1, pos_m.unsqueeze(-1).expand(-1, -1, h.shape[-1]))
    logits = mlm_logits(P, "cls.predictions.", word, g, prod)
    per_pos = label_smoothing(logits, batch["masked_ids"].long(),
                              dims["label_smoothing"])
    w = batch["masked_weights"].float()
    return (per_pos * w).sum() / (w.sum() + 1e-5)
