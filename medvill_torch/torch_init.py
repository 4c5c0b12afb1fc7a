"""Pretrained weights from torch checkpoint files (the counterpart of
medvill_tpu/core/torch_init.py:27-375 and the import shims it calls in
core/checkpoint.py:232-264,339-438): state-dict remaps into the port's
``nn.Module``s, each tensor shape-checked, the model changed in place.

- ``load_torch_state_dict``: a ``.pth``/``.bin``/``.pt`` file as a flat
  {key: tensor} dict, ``{"state_dict": ...}`` / ``{"model": ...}``
  unwrapped (read with ``weights_only``: a file of tensors and plain
  containers, as every reference checkpoint is).
- ``init_resnet_from_torch``: torchvision ResNet-50 names (the trunk found
  by its ``conv1.weight``, whatever prefix a full-model file gives it) into
  a ``ResNet50Trunk`` (reference: models/image.py:50).  Every parameter and
  running statistic of the trunk must be in the file with its shape.
- ``init_bert_from_torch``: an HF BERT file (``bert.*`` or bare names) into
  the embeddings, encoder and pooler under ``enc_key`` (reference:
  cxrbert_origin.py:42-55).  A position table of another size is resized
  and a token-type table of another size expanded
  (``checkpoint.resize_position_embeddings``,
  ``expand_token_type_embeddings``).
- ``init_cxrbert_from_torch``: a CXRBERT pretrain file in the reference
  layout (``enc.* mlm.* itm.*``; the port's pretrain and retrieval CLIs
  write it) into a ``CXRBERT`` (reference: Retrieval/retrieval.py:17-24).
- ``init_cnn_bert_from_torch``: a CNN_BERT file (``txt_enc.* img_enc.model.*
  linear.*``) into a ``CNNBert`` (reference: full_dset_retrieval.py:549-555).
- ``is_torch_checkpoint``: a file, or a directory holding
  ``pytorch_model.bin`` (the HF ``from_pretrained`` layout).

``enc_key`` and ``trunk_path`` name the submodules as the JAX tree names
them.  ``VLPForPreTraining`` subclasses the encoder the JAX model holds as
``bert``, so there ``bert`` names the model itself.  The JAX
``partial_freeze_mask`` has no counterpart: the port freezes by
``requires_grad``.  A file that lacks a tensor the remap needs, or holds
one of another shape, raises ValueError.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from medvill_torch.checkpoint import (expand_token_type_embeddings,
                                      resize_position_embeddings)

StateDict = Dict[str, torch.Tensor]

# torchvision top-level names -> the trunk's nn.Sequential indices
# (reference models/image.py:46-52 keeps resnet50.children()[:-2])
_TRUNK_IDX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
              "layer3": "6", "layer4": "7"}
_SEQ_TO_TORCHVISION = {v: k for k, v in _TRUNK_IDX.items()}
_STATS = "num_batches_tracked"
# one encoder layer's tensors, HF and port names alike
_LAYER_KEYS = tuple(
    f"{m}.{p}" for m in ("attention.self.query", "attention.self.key",
                         "attention.self.value", "attention.output.dense",
                         "attention.output.LayerNorm", "intermediate.dense",
                         "output.dense", "output.LayerNorm")
    for p in ("weight", "bias"))


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint file as a flat {key: tensor} dict; non-tensor
    entries are dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping):
        for wrapper in ("state_dict", "model"):
            if isinstance(obj.get(wrapper), Mapping):
                obj = obj[wrapper]
                break
    out: StateDict = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
    return out


def _as_state_dict(sd_or_path: Union[str, Mapping]) -> StateDict:
    if isinstance(sd_or_path, str):
        return load_torch_state_dict(sd_or_path)
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in sd_or_path.items()}


def _strip_module_prefix(sd: StateDict) -> StateDict:
    """nn.DataParallel saves with a ``module.`` prefix (reference trainer,
    models/train_origin.py:53-55)."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def _strip_prefixes(sd: StateDict, markers=("conv1.weight",)) -> StateDict:
    """The torchvision-ResNet keys of a file with the trunk under a prefix
    (``img_encoder.model.`` inside a full-model checkpoint, say), the
    prefix found by ``markers`` and stripped."""
    for marker in markers:
        if marker in sd:
            return sd
        hits = [k for k in sd if k.endswith("." + marker)]
        if hits:
            prefix = hits[0][: -len(marker)]
            return {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
    return sd


def _submodule(model: nn.Module, path: Sequence[str]) -> nn.Module:
    mod = model
    for name in path:
        if name == "bert" and not hasattr(mod, "bert"):
            continue  # VLPForPreTraining is its own encoder
        mod = getattr(mod, name)
    return mod


def _assign(module: nn.Module, new: StateDict, where: str,
            required: Sequence[str] = ()) -> List[str]:
    """Copy ``new`` into ``module``'s tensors: each key must be the
    module's, with its shape, and every key of ``required`` present."""
    own = module.state_dict()
    missing = [k for k in required if k not in new]
    if missing:
        raise ValueError(f"{where}: the checkpoint lacks {len(missing)} "
                         f"tensors, e.g. {missing[:5]}")
    for k, v in new.items():
        if k not in own:
            raise ValueError(f"{where}: no tensor {k} in the model")
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{where}.{k}: shape {tuple(v.shape)} != "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict(new, strict=False)
    return sorted(new)


def _need(sd: StateDict, key: str) -> torch.Tensor:
    if key not in sd:
        raise ValueError(f"the checkpoint lacks {key}")
    return sd[key]


def init_resnet_from_torch(model: nn.Module,
                           sd_or_path: Union[str, Mapping],
                           trunk_path: Sequence[str] = ("enc", "img_encoder"),
                           ) -> List[str]:
    """Replace the ResNet-50 trunk at ``trunk_path`` (parameters and
    running statistics) with torchvision-named weights.  Returns the
    trunk's keys set."""
    sd = _strip_prefixes(_as_state_dict(sd_or_path))
    new = {}
    for k, v in sd.items():
        head, _, tail = k.partition(".")
        if head in _TRUNK_IDX and not k.endswith(_STATS):
            new[f"model.{_TRUNK_IDX[head]}.{tail}"] = v
    trunk = _submodule(model, trunk_path)
    required = [k for k in trunk.state_dict() if not k.endswith(_STATS)]
    return _assign(trunk, new, ".".join(trunk_path), required)


def _sequential_trunk_sd(sd: StateDict, prefix: str) -> StateDict:
    """``{prefix}.model.{i}...`` nn.Sequential keys -> torchvision names."""
    out: StateDict = {}
    base = prefix + ".model."
    for k, v in sd.items():
        if not k.startswith(base):
            continue
        idx, _, tail = k[len(base):].partition(".")
        if idx in _SEQ_TO_TORCHVISION:  # relu / maxpool have none
            out[f"{_SEQ_TO_TORCHVISION[idx]}.{tail}"] = v
    return out


def _bert_sd_from_vendored(sd: StateDict, txt_prefix: str, enc_prefix: str,
                           pool_prefix: str) -> StateDict:
    """A model's text-encoder keys under the plain ``embeddings.`` /
    ``encoder.`` / ``pooler.`` names of an HF BERT file."""
    out: StateDict = {}
    for k, v in sd.items():
        for src, dst in ((txt_prefix, "embeddings."),
                         (enc_prefix, "encoder."), (pool_prefix, "pooler.")):
            if k.startswith(src + "."):
                out[dst + k[len(src) + 1:]] = v
    return out


def load_hf_bert_into_joint(model: nn.Module,
                            hf_state_dict: Union[str, Mapping],
                            num_layers: Optional[int] = None,
                            enc_key: str = "enc") -> List[str]:
    """The embeddings, the first ``num_layers`` encoder layers (the
    encoder's own count by default, which they must equal) and, where both
    have one, the pooler of an HF BERT state dict into the encoder under
    ``enc_key``; the image projection and the heads keep their values.
    Returns the encoder's keys set."""
    sd = _as_state_dict(hf_state_dict)
    enc = _submodule(model, [enc_key] if enc_key else [])
    own = enc.state_dict()
    n = len(enc.encoder.layer)
    if num_layers is not None and num_layers != n:
        raise ValueError(f"{enc_key}: {num_layers} layers asked for, the "
                         f"model has {n}")
    emb = ("bert.embeddings" if "bert.embeddings.word_embeddings.weight" in sd
           else "embeddings")
    encp = emb.replace("embeddings", "encoder")
    poolp = emb.replace("embeddings", "pooler")
    new: StateDict = {}
    for name in ("word_embeddings.weight", "position_embeddings.weight",
                 "token_type_embeddings.weight", "LayerNorm.weight",
                 "LayerNorm.bias"):
        new[f"txt_embeddings.{name}"] = _need(sd, f"{emb}.{name}")
    for i in range(n):
        for name in _LAYER_KEYS:
            new[f"encoder.layer.{i}.{name}"] = _need(
                sd, f"{encp}.layer.{i}.{name}")
    if f"{poolp}.dense.weight" in sd and "pooler.dense.weight" in own:
        for p in ("weight", "bias"):
            new[f"pooler.dense.{p}"] = sd[f"{poolp}.dense.{p}"]
    pos = "txt_embeddings.position_embeddings.weight"
    if new[pos].shape[0] != own[pos].shape[0]:
        new[pos] = torch.from_numpy(resize_position_embeddings(
            new[pos].numpy(), own[pos].shape[0]))
    types = "txt_embeddings.token_type_embeddings.weight"
    new[types] = torch.from_numpy(expand_token_type_embeddings(
        new[types].numpy(), own[types].cpu().numpy()))
    return _assign(enc, new, enc_key or "model")


def init_bert_from_torch(model: nn.Module, sd_or_path: Union[str, Mapping],
                         enc_key: str = "enc",
                         num_layers: Optional[int] = None) -> List[str]:
    """An HF ``pytorch_model.bin`` into the BERT under ``enc_key``
    (reference: cxrbert_origin.py:42-55, mmbt BertModel.from_pretrained)."""
    return load_hf_bert_into_joint(model, sd_or_path, num_layers=num_layers,
                                   enc_key=enc_key)


def _set_checked(model: nn.Module, sd: StateDict, pairs) -> List[str]:
    """(model key, file key) pairs, each file tensor required."""
    return _assign(model, {mk: _need(sd, fk) for mk, fk in pairs}, "model")


def init_cxrbert_from_torch(model: nn.Module, sd_or_path: Union[str, Mapping],
                            enc_key: str = "enc") -> List[str]:
    """A torch CXRBERT pretrain file into a ``CXRBERT``: the text encoder,
    the image projection, the trunk (when the file has one), the MLM head
    (when present; its decoder is the word-embedding table) and the ITM
    head (when present).  Returns the model keys set."""
    sd = _strip_module_prefix(_as_state_dict(sd_or_path))
    bert_sd = _bert_sd_from_vendored(sd, "enc.txt_embeddings", "enc.encoder",
                                     "enc.pooler")
    if not bert_sd:
        raise ValueError("no enc.txt_embeddings/enc.encoder keys: not a "
                         "CXRBERT pretrain checkpoint")
    loaded = [f"{enc_key}.{k}" for k in load_hf_bert_into_joint(
        model, bert_sd, enc_key=enc_key)]
    proj = "img_embeddings.img_embeddings"
    loaded += _set_checked(model, sd, [
        (f"{enc_key}.{proj}.{p}", f"enc.{proj}.{p}")
        for p in ("weight", "bias")])
    trunk_sd = _sequential_trunk_sd(sd, "enc.img_encoder")
    if trunk_sd:
        loaded += [f"{enc_key}.img_encoder.{k}" for k in
                   init_resnet_from_torch(model, trunk_sd,
                                          (enc_key, "img_encoder"))]
    if "mlm.predictions.transform.dense.weight" in sd:
        loaded += _set_checked(model, sd, [
            (k, k) for k in (
                "mlm.predictions.transform.dense.weight",
                "mlm.predictions.transform.dense.bias",
                "mlm.predictions.transform.LayerNorm.weight",
                "mlm.predictions.transform.LayerNorm.bias",
                "mlm.predictions.bias")])
    if "itm.linear.weight" in sd:
        loaded += _set_checked(model, sd, [
            (k, k) for k in ("itm.linear.weight", "itm.linear.bias")])
    return sorted(loaded)


def init_cnn_bert_from_torch(model: nn.Module,
                             sd_or_path: Union[str, Mapping]) -> List[str]:
    """A torch CNN_BERT file into a ``CNNBert``: the text encoder, the trunk
    (when present) and the fusion Linear (when present; the reference
    concatenates [image, text] as the port does).  Returns the model keys
    set."""
    sd = _strip_module_prefix(_as_state_dict(sd_or_path))
    bert_sd = _bert_sd_from_vendored(sd, "txt_enc.txt_embeddings",
                                     "txt_enc.encoder", "txt_enc.pooler")
    if not bert_sd:
        raise ValueError("no txt_enc.* keys: not a CNN_BERT checkpoint")
    loaded = [f"txt_enc.{k}" for k in load_hf_bert_into_joint(
        model, bert_sd, enc_key="txt_enc")]
    trunk_sd = _sequential_trunk_sd(sd, "img_enc")
    if trunk_sd:
        loaded += [f"img_enc.{k}" for k in
                   init_resnet_from_torch(model, trunk_sd, ("img_enc",))]
    if "linear.weight" in sd:
        loaded += _set_checked(model, sd, [
            (k, k) for k in ("linear.weight", "linear.bias")])
    return sorted(loaded)


def is_torch_checkpoint(path: str) -> bool:
    """A file, or a directory holding ``pytorch_model.bin`` (the HF
    ``save_pretrained`` layout, reference retrieval.py:19)."""
    if os.path.isfile(path):
        return True
    return os.path.isfile(os.path.join(path, "pytorch_model.bin"))
