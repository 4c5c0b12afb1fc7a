"""The pretraining model (CXRBERT), the reference repo's pretrain
``state_dict``: names under ``enc.``, ``mlm.`` and ``itm.``.

``loss``: ``[CLS] img(N) [SEP] txt`` with the random-pixel fibers as image
tokens (their pixel index is their position id), the MLM cross-entropy
averaged over the labeled positions plus the ITM cross-entropy averaged
over the batch (``models/train_origin.py``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import masks
from benchmark.reference.dropout import StepRandomness
from benchmark.reference.models import (Spec, embed, encoder, joint_spec,
                                       layer_norm, linear_spec, mlm_logits,
                                       trunk_fibers)
from benchmark.reference.precision import Products

TRUNK = "enc.img_encoder.model."


def param_spec(dims: dict) -> Spec:
    return joint_spec("enc.", TRUNK, "mlm.predictions.", dims) + linear_spec(
        "itm.linear", 2, dims["hidden_size"])


def trainable(name: str) -> bool:
    """The trunk is frozen; its BatchNorm statistics are not parameters."""
    return not name.startswith(TRUNK)


def pixels(dims: dict):
    return dims["num_fibers"]


def loss(P, batch: Dict[str, torch.Tensor], pix: torch.Tensor,
         rnd: StepRandomness, dims: dict, prod: Products) -> torch.Tensor:
    eps = dims["layer_norm_eps"]
    dev = batch["input_txt"].device
    N = pix.shape[0]
    with torch.no_grad():
        fibers = trunk_fibers(P, TRUNK, batch["image"], prod)
    pix = pix.to(dev)
    e = "enc.txt_embeddings."
    x = prod.linear(fibers[:, pix], P["enc.img_embeddings.img_embeddings."
                                      "weight"],
                    P["enc.img_embeddings.img_embeddings.bias"])
    x = (x + P[e + "position_embeddings.weight"][pix]
         + P[e + "token_type_embeddings.weight"][0])
    img = rnd.plain(layer_norm(x, P[e + "LayerNorm.weight"],
                               P[e + "LayerNorm.bias"], eps, prod))
    B = x.shape[0]
    zero = torch.zeros((B, 1), dtype=torch.long, device=dev)
    cls = embed(P, "enc.", batch["cls_tok"].long(), zero, zero, eps, rnd,
                 prod)
    sep = embed(P, "enc.", batch["sep_tok"].long(), zero, zero, eps, rnd,
                 prod)
    T = batch["input_txt"].shape[1]
    txt = embed(P, "enc.", batch["input_txt"].long(),
                 batch["segment"].long(),
                 torch.arange(T, device=dev).expand(B, T), eps, rnd, prod)
    h = torch.cat([cls, img, sep, txt], dim=1)
    L = h.shape[1]
    bias = masks.additive_bias("pretrain", batch["mask_spec"], L, N + 2)
    h = encoder(P, "enc.", h, bias, dims, rnd, prod)
    pooled = prod.act(torch.tanh(prod.linear(
        h[:, 0], P["enc.pooler.dense.weight"], P["enc.pooler.dense.bias"])))
    itm = prod.linear(pooled, P["itm.linear.weight"], P["itm.linear.bias"],
                      act=False)
    itm_loss = F.cross_entropy(itm, batch["is_aligned"].long())
    labels = batch["txt_labels"].long()
    rows, cols = torch.nonzero(labels != -100, as_tuple=True)
    logits = mlm_logits(P, "mlm.predictions.",
                        P[e + "word_embeddings.weight"], h[rows, cols], prod)
    mlm_loss = F.cross_entropy(logits, labels[rows, cols])
    return mlm_loss + itm_loss
