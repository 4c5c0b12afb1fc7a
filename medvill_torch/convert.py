"""Weights carried across into the port.

- ``vlp_state_dict_from_flax(params, batch_stats)``: the JAX package's VLP
  parameter tree (numpy arrays or anything ``np.asarray`` takes) -> a flat
  state dict in the reference finetune layout.  A jax-free copy of
  ``medvill_tpu.core.torch_export.export_vlp_state_dict`` and its helpers
  (core/torch_export.py:43-215): Dense ``kernel`` -> ``weight.T``, LayerNorm
  ``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``, Conv HWIO ->
  OIHW, BatchNorm stats -> ``running_mean``/``running_var``, the tied MLM
  decoder materialised from the word embeddings.
- ``load_vlp_checkpoint(model, path)``: a reference ``model.{N}.bin``
  (or one written by ``save_state_dict``) into a ``VLPForPreTraining``;
  ``module.``/``bert.`` prefixes are stripped as
  ``medvill_tpu.core.torch_init.init_vlp_from_torch`` does.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, np.ndarray]

_TRUNK_SEQ_IDX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                  "layer3": "6", "layer4": "7"}
_STAGE_SIZES = (3, 4, 6, 3)


def _np(v) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype not in (np.float32, np.float64, np.int32, np.int64):
        a = a.astype(np.float32)   # bf16 / f16 leaves export as f32
    return a


def _lin(out: StateDict, prefix: str, sub: dict) -> None:
    out[prefix + ".weight"] = _np(sub["kernel"]).T
    out[prefix + ".bias"] = _np(sub["bias"])


def _ln(out: StateDict, prefix: str, sub: dict) -> None:
    out[prefix + ".weight"] = _np(sub["scale"])
    out[prefix + ".bias"] = _np(sub["bias"])


def _embeddings(out: StateDict, prefix: str, emb: dict) -> None:
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"{prefix}.{name}.weight"] = _np(emb[name]["embedding"])
    _ln(out, f"{prefix}.LayerNorm", emb["LayerNorm"])


def _encoder(out: StateDict, prefix: str, encoder: dict) -> None:
    """BertEncoder layers -> ``{prefix}.layer.{i}.*``; a fused ``self/qkv``
    kernel is split back into query/key/value."""
    for i in range(len(encoder)):
        layer = encoder[f"layer_{i}"]
        lp = f"{prefix}.layer.{i}"
        s = layer["self"]
        if "qkv" in s:
            kernel, bias = _np(s["qkv"]["kernel"]), _np(s["qkv"]["bias"])
            H = kernel.shape[0]
            for j, name in enumerate(("query", "key", "value")):
                out[f"{lp}.attention.self.{name}.weight"] = \
                    kernel[:, j * H:(j + 1) * H].T
                out[f"{lp}.attention.self.{name}.bias"] = \
                    bias[j * H:(j + 1) * H]
        else:
            for name in ("query", "key", "value"):
                _lin(out, f"{lp}.attention.self.{name}", s[name])
        _lin(out, f"{lp}.attention.output.dense",
             layer["attention_output"]["dense"])
        _ln(out, f"{lp}.attention.output.LayerNorm",
            layer["attention_output"]["LayerNorm"])
        _lin(out, f"{lp}.intermediate.dense", layer["intermediate"])
        _lin(out, f"{lp}.output.dense", layer["output_dense"])
        _ln(out, f"{lp}.output.LayerNorm", layer["output_LayerNorm"])


def _trunk(out: StateDict, prefix: str, params: dict,
           batch_stats: dict) -> None:
    """ResNet50Trunk -> ``{prefix}.model.{0,1,4..7}.*`` torchvision names."""
    def conv(dst: str, sub: dict) -> None:
        out[dst + ".weight"] = _np(sub["kernel"]).transpose(3, 2, 0, 1)

    def bn(dst: str, p_sub: dict, s_sub: dict) -> None:
        out[dst + ".weight"] = _np(p_sub["scale"])
        out[dst + ".bias"] = _np(p_sub["bias"])
        out[dst + ".running_mean"] = _np(s_sub["mean"])
        out[dst + ".running_var"] = _np(s_sub["var"])
        out[dst + ".num_batches_tracked"] = np.zeros((), np.int64)

    base = prefix + ".model."
    conv(base + "0", params["conv1"])
    bn(base + "1", params["bn1"], batch_stats["bn1"])
    for stage, n_blocks in enumerate(_STAGE_SIZES):
        for block in range(n_blocks):
            src = f"layer{stage + 1}_{block}"
            dst = f"{base}{_TRUNK_SEQ_IDX[f'layer{stage + 1}']}.{block}"
            bp, bs = params[src], batch_stats[src]
            for ci in (1, 2, 3):
                conv(f"{dst}.conv{ci}", bp[f"conv{ci}"])
                bn(f"{dst}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "downsample_conv" in bp:
                conv(f"{dst}.downsample.0", bp["downsample_conv"])
                bn(f"{dst}.downsample.1", bp["downsample_bn"],
                   bs["downsample_bn"])


def vlp_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                             ) -> StateDict:
    """JAX VLP finetune tree (``{"bert": ..., "cls": ...}`` params and
    ``{"bert": {"img_encoder": ...}}`` batch stats) -> the reference
    ``model.{N}.bin`` layout, as numpy arrays."""
    out: StateDict = {}
    bert = params["bert"]
    _embeddings(out, "txt_embeddings", bert["embeddings"])
    _lin(out, "img_embeddings.img_embeddings", bert["img_projection"])
    _trunk(out, "img_encoder", bert["img_encoder"],
           batch_stats["bert"]["img_encoder"])
    _encoder(out, "encoder", bert["encoder"])
    _lin(out, "pooler.dense", bert["pooler"]["dense"])
    if "cls" in params:
        head = params["cls"]
        _lin(out, "cls.predictions.transform.dense", head["transform_dense"])
        _ln(out, "cls.predictions.transform.LayerNorm",
            head["transform_LayerNorm"])
        out["cls.predictions.decoder.weight"] = _np(
            bert["embeddings"]["word_embeddings"]["embedding"])
        out["cls.predictions.bias"] = _np(head["decoder_bias"])
    if "ans_classifier" in params:
        _lin(out, "ans_classifier.0", params["ans_classifier"]["fc1"])
        _lin(out, "ans_classifier.2", params["ans_classifier"]["fc2"])
    return out


def save_state_dict(sd: Mapping[str, np.ndarray], path: str) -> None:
    """``torch.save`` a flat numpy state dict as tensors (the format every
    reference ``torch.load`` site reads)."""
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}, path)


def _strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    if not any(k.startswith(prefix) for k in sd):
        return sd
    return {(k[len(prefix):] if k.startswith(prefix) else k): v
            for k, v in sd.items()}


def load_vlp_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a torch finetune checkpoint file into ``model``.

    Unwraps ``{"state_dict": ...}`` / ``{"model": ...}`` containers and
    strips the ``module.`` (DataParallel) and ``bert.`` prefixes.  Every
    parameter and buffer the model owns must be present with its shape
    (else ValueError / RuntimeError); keys the model does not own, such as a
    VQA ``ans_classifier``, are returned for the caller to log."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port serves torch checkpoint files "
            "only.  Convert an orbax checkpoint with `python -m "
            "medvill_tpu.cli.export_main --checkpoint <dir> --output "
            "model.bin` first.")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(obj.get(wrapper), Mapping):
            obj = obj[wrapper]
            break
    sd = _strip(_strip(dict(obj), "module."), "bert.")
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"checkpoint {path} lacks {len(missing)} model "
                         f"keys, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return sorted(set(sd) - set(own))
