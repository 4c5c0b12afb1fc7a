"""The pieces of MedViLL's models, written plainly over a dict of named
tensors; each model (``cxrbert.py``: pretraining, ``vlp.py``: report
generation) is a module of its own that ``load`` finds by name.

- ``joint_spec`` lists every parameter and BatchNorm statistic of the
  joint encoder, its image trunk and its MLM head, with its shape and how
  it is drawn.  The MLM decoder is the word embedding table (tied), so it
  is not listed.
- The image trunk is torchvision's ResNet-50 (v1.5: the stride on the 3x3
  convolution) up to layer4, frozen, its BatchNorm on the batch's
  statistics (biased variance); its 16 x 16 fibers at 512 px feed a
  ``Linear(2048, hidden)``.
- The joint encoder is post-LN BERT: exact-erf GELU, softmax over the
  scaled scores plus the -10000 mask bias, dropout on the attention
  probabilities and before each residual add.
- ``label_smoothing``: KL to the smoothed one-hot, the target ``1 -
  eps``, the other columns but 0 ``eps / (V - 2)``, a position whose label
  is 0 counting nothing (``pytorch_pretrained_bert/loss.py``).

Every product, and every activation that the program holds in its
compute dtype, goes through ``precision.Products``: float32 throughout for
the reference, float8 there for the control.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.dropout import StepRandomness
from benchmark.reference.precision import Products

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
HEAD_LN_EPS = 1e-5
STAGES = (3, 4, 6, 3)

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _resnet_spec(pre: str, width: int = 64) -> Spec:
    out: Spec = [(pre + "0.weight", (width, 3, 7, 7), "conv")]
    out += _bn_spec(pre + "1.", width)
    in_ch = width
    for s, n in enumerate(STAGES):
        w = width * 2 ** s
        for b in range(n):
            p = f"{pre}{4 + s}.{b}."
            out += [(p + "conv1.weight", (w, in_ch, 1, 1), "conv")]
            out += _bn_spec(p + "bn1.", w)
            out += [(p + "conv2.weight", (w, w, 3, 3), "conv")]
            out += _bn_spec(p + "bn2.", w)
            out += [(p + "conv3.weight", (4 * w, w, 1, 1), "conv")]
            out += _bn_spec(p + "bn3.", 4 * w)
            if b == 0:
                out += [(p + "downsample.0.weight", (4 * w, in_ch, 1, 1),
                         "conv")]
                out += _bn_spec(p + "downsample.1.", 4 * w)
            in_ch = 4 * w
    return out


def _bn_spec(pre: str, c: int) -> Spec:
    return [(pre + "weight", (c,), "ones"), (pre + "bias", (c,), "zeros"),
            (pre + "running_mean", (c,), "zeros"),
            (pre + "running_var", (c,), "ones")]


def linear_spec(name: str, n_out: int, n_in: int) -> Spec:
    return [(name + ".weight", (n_out, n_in), "normal"),
            (name + ".bias", (n_out,), "zeros")]


def _ln(name: str, n: int) -> Spec:
    return [(name + ".weight", (n,), "ones"), (name + ".bias", (n,), "zeros")]


def joint_spec(pre: str, trunk: str, head: str, dims: dict) -> Spec:
    """(name, shape, draw) of every tensor of the joint encoder under
    ``pre``, its trunk under ``trunk`` and its MLM head under ``head``;
    draw is "normal" (N(0, initializer_range)), "conv" (N(0, 1/fan_in)),
    "zeros" or "ones"."""
    H, V = dims["hidden_size"], dims["vocab_size"]
    out: Spec = [
        (pre + "txt_embeddings.word_embeddings.weight", (V, H), "normal"),
        (pre + "txt_embeddings.position_embeddings.weight",
         (dims["max_position_embeddings"], H), "normal"),
        (pre + "txt_embeddings.token_type_embeddings.weight",
         (dims["type_vocab_size"], H), "normal")]
    out += _ln(pre + "txt_embeddings.LayerNorm", H)
    out += _resnet_spec(trunk)
    out += linear_spec(pre + "img_embeddings.img_embeddings",
                   H, dims["img_hidden_size"])
    for i in range(dims["num_hidden_layers"]):
        p = f"{pre}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            out += linear_spec(p + "attention.self." + n, H, H)
        out += linear_spec(p + "attention.output.dense", H, H)
        out += _ln(p + "attention.output.LayerNorm", H)
        out += linear_spec(p + "intermediate.dense",
                           dims["intermediate_size"], H)
        out += linear_spec(p + "output.dense", H, dims["intermediate_size"])
        out += _ln(p + "output.LayerNorm", H)
    out += linear_spec(pre + "pooler.dense", H, H)
    out += linear_spec(head + "transform.dense", H, H)
    out += _ln(head + "transform.LayerNorm", H)
    out += [(head + "bias", (V,), "zeros")]
    return out


def decayed(name: str) -> bool:
    """BertAdam's decay group: not a LayerNorm or BatchNorm parameter and
    not a Linear's bias (the MLM head's free vocabulary bias decays)."""
    if "LayerNorm" in name or name.endswith(("running_mean", "running_var")):
        return False
    if name.endswith(".bias"):
        return name.endswith("predictions.bias")
    return True


def layer_norm(x, w, b, eps: float, prod: Products):
    return prod.act(F.layer_norm(x, (x.shape[-1],), w, b, eps))


def _bn(P, pre: str, x, prod: Products):
    return prod.act(F.batch_norm(x, None, None, P[pre + "weight"],
                                 P[pre + "bias"], training=True, eps=BN_EPS))


def trunk_fibers(P: Dict[str, torch.Tensor], pre: str, image: torch.Tensor,
                 prod: Products) -> torch.Tensor:
    """uint8 NHWC images -> [B, (H/32)*(W/32), 2048] row-major fibers."""
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    x = ((image.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    x = torch.relu(_bn(P, pre + "1.", prod.conv2d(x, P[pre + "0.weight"],
                                                  2, 3), prod))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s, n in enumerate(STAGES):
        for b in range(n):
            p = f"{pre}{4 + s}.{b}."
            stride = 2 if (s > 0 and b == 0) else 1
            y = torch.relu(_bn(P, p + "bn1.", prod.conv2d(
                x, P[p + "conv1.weight"], 1, 0), prod))
            y = torch.relu(_bn(P, p + "bn2.", prod.conv2d(
                y, P[p + "conv2.weight"], stride, 1), prod))
            y = _bn(P, p + "bn3.", prod.conv2d(y, P[p + "conv3.weight"], 1,
                                               0), prod)
            res = x
            if b == 0:
                res = _bn(P, p + "downsample.1.", prod.conv2d(
                    x, P[p + "downsample.0.weight"], stride, 0), prod)
            x = torch.relu(y + res)
    B, C, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, h * w, C)


def encoder(P, pre: str, h: torch.Tensor, bias: torch.Tensor, dims: dict,
            rnd: StepRandomness, prod: Products) -> torch.Tensor:
    B, L, H = h.shape
    heads = dims["num_attention_heads"]
    d = H // heads
    eps = dims["layer_norm_eps"]
    for i in range(dims["num_hidden_layers"]):
        p = f"{pre}encoder.layer.{i}."

        def lin(name, x):
            return prod.linear(x, P[p + name + ".weight"],
                               P[p + name + ".bias"])

        q, k, v = (lin("attention.self." + n, h).view(B, L, heads, d)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        scores = prod.matmul(q, k.transpose(-1, -2)) / math.sqrt(d) + bias
        probs = rnd.attention(torch.softmax(scores, dim=-1))
        ctx = prod.act(prod.matmul(probs, v)).transpose(1, 2).reshape(
            B, L, H)
        a = lin("attention.output.dense", ctx)
        h1 = layer_norm(rnd.rows(a) + h, P[p + "attention.output.LayerNorm."
                                           "weight"],
                        P[p + "attention.output.LayerNorm.bias"], eps, prod)
        f = lin("output.dense",
                prod.act(F.gelu(lin("intermediate.dense", h1))))
        h = layer_norm(rnd.rows(f) + h1, P[p + "output.LayerNorm.weight"],
                       P[p + "output.LayerNorm.bias"], eps, prod)
    return h


def embed(P, pre: str, ids, types, positions, eps: float,
           rnd: StepRandomness, prod: Products) -> torch.Tensor:
    e = pre + "txt_embeddings."
    x = (P[e + "word_embeddings.weight"][ids]
         + P[e + "position_embeddings.weight"][positions]
         + P[e + "token_type_embeddings.weight"][types])
    return rnd.plain(layer_norm(x, P[e + "LayerNorm.weight"],
                                P[e + "LayerNorm.bias"], eps, prod))


def mlm_logits(P, head: str, word: torch.Tensor, x: torch.Tensor,
               prod: Products) -> torch.Tensor:
    t = F.gelu(prod.linear(x, P[head + "transform.dense.weight"],
                           P[head + "transform.dense.bias"]))
    t = layer_norm(t, P[head + "transform.LayerNorm.weight"],
                   P[head + "transform.LayerNorm.bias"], HEAD_LN_EPS, prod)
    return prod.matmul(t, word.t()) + P[head + "bias"]


def label_smoothing(logits: torch.Tensor, labels: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Per position: KL(smoothed one-hot || softmax(logits)), 0 where the
    label is 0 (see the module docstring)."""
    V = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    other = eps / (V - 2)
    gold = torch.gather(logp, -1, labels.unsqueeze(-1)).squeeze(-1)
    rest = logp.sum(-1) - logp[..., 0] - gold
    entropy = (1 - eps) * math.log(1 - eps) + eps * math.log(other)
    kl = entropy - (1 - eps) * gold - other * rest
    return torch.where(labels != 0, kl, 0.0)




def load(model: str):
    """The reference module of ``model``: ``reference/<model>.py``, with
    its ``TRUNK`` prefix, ``param_spec(dims)``, ``trainable(name)``,
    ``pixels(dims)`` (the fibers a random-pixel draw picks from, or None)
    and ``loss(P, batch, pix, rnd, dims, prod)``."""
    return importlib.import_module(f"benchmark.reference.{model}")
