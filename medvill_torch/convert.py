"""Weights carried across into the port.

- ``vlp_state_dict_from_flax(params, batch_stats)``: the JAX package's VLP
  parameter tree (numpy arrays or anything ``np.asarray`` takes) -> a flat
  state dict in the reference finetune layout.  A jax-free copy of
  ``medvill_tpu.core.torch_export.export_vlp_state_dict`` and its helpers
  (core/torch_export.py:43-215): Dense ``kernel`` -> ``weight.T``, LayerNorm
  ``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``, Conv HWIO ->
  OIHW, BatchNorm stats -> ``running_mean``/``running_var``, the tied MLM
  decoder materialised from the word embeddings.
- ``cxrbert_state_dict_from_flax(params, batch_stats)``: the JAX
  package's CXRBERT pretrain tree -> the reference pretrain layout
  (``enc.* mlm.predictions.* itm.linear.*``), a jax-free copy of
  ``export_cxrbert_state_dict`` (core/torch_export.py:143-194) that also
  carries a ViT model's ``enc.img_encoder.patch_to_embedding.*``, which
  the JAX export drops (it exports the image encoder only when it has
  ``conv1``).
- ``mmbt_state_dict_from_flax(params, batch_stats)``: the JAX package's
  MMBT classification tree -> the reference MMBT layout (``enc.*
  clf.*``), a jax-free copy of ``export_mmbt_state_dict``
  (core/torch_export.py:241-255).
- ``cnn_bert_state_dict_from_flax(params, batch_stats)``: the JAX
  package's CNN_BERT retrieval baseline -> the reference CNN_BERT layout
  (``txt_enc.* img_enc.model.* linear.*``), a jax-free copy of
  ``export_cnn_bert_state_dict`` (core/torch_export.py:218-238).
- ``load_vlp_checkpoint(model, path)``: a reference ``model.{N}.bin``
  (or one written by ``save_state_dict``) into a ``VLPForPreTraining``;
  ``module.``/``bert.`` prefixes are stripped as
  ``medvill_tpu.core.torch_init.init_vlp_from_torch`` does.
- ``load_cxrbert_checkpoint(model, path)``: a pretrain checkpoint in the
  CXRBERT layout (the pretrain CLI writes them) into a ``CXRBERT``.
- ``load_mmbt_checkpoint(model, path)``: a classification checkpoint in
  the MMBT layout (the classification CLI writes them) into a
  ``MultimodalBertClf``.
- ``load_cnn_bert_checkpoint(model, path)``: a retrieval checkpoint in
  the CNN_BERT layout (the retrieval CLI's ``--CXRBERT false`` branch
  writes them) into a ``CNNBert``.
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
        _mlm_head(out, "cls.predictions", params["cls"],
                  bert["embeddings"]["word_embeddings"]["embedding"])
    if "ans_classifier" in params:
        _lin(out, "ans_classifier.0", params["ans_classifier"]["fc1"])
        _lin(out, "ans_classifier.2", params["ans_classifier"]["fc2"])
    return out


def _mlm_head(out: StateDict, prefix: str, head: dict,
              word_embedding) -> None:
    _lin(out, f"{prefix}.transform.dense", head["transform_dense"])
    _ln(out, f"{prefix}.transform.LayerNorm", head["transform_LayerNorm"])
    out[f"{prefix}.decoder.weight"] = _np(word_embedding)
    out[f"{prefix}.bias"] = _np(head["decoder_bias"])


def cxrbert_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                                 ) -> StateDict:
    """JAX CXRBERT pretrain tree (``{"enc": ..., "mlm": ..., "itm": ...}``
    params, ``{"enc": {"img_encoder": ...}}`` batch stats) -> the reference
    pretrain ``state_dict`` layout, as numpy arrays."""
    out: StateDict = {}
    enc = params["enc"]
    _embeddings(out, "enc.txt_embeddings", enc["embeddings"])
    _lin(out, "enc.img_embeddings.img_embeddings", enc["img_projection"])
    if "patch_to_embedding" in enc["img_encoder"]:
        # the ViT encoder, which export_cxrbert_state_dict drops
        _lin(out, "enc.img_encoder.patch_to_embedding",
             enc["img_encoder"]["patch_to_embedding"])
    else:
        _trunk(out, "enc.img_encoder", enc["img_encoder"],
               batch_stats["enc"]["img_encoder"])
    _encoder(out, "enc.encoder", enc["encoder"])
    if "pooler" in enc:  # a model built for NONCROSS only has none
        _lin(out, "enc.pooler.dense", enc["pooler"]["dense"])
    if "mlm" in params:
        _mlm_head(out, "mlm.predictions", params["mlm"],
                  enc["embeddings"]["word_embeddings"]["embedding"])
    if "itm" in params:
        _lin(out, "itm.linear", params["itm"]["linear"])
    return out


def mmbt_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                              ) -> StateDict:
    """JAX MMBT tree (``{"enc": ..., "clf": {"clf": ...}}`` params,
    ``{"enc": {"img_encoder": ...}}`` batch stats) -> the reference MMBT
    ``state_dict`` layout, as numpy arrays."""
    out: StateDict = {}
    enc = params["enc"]
    _embeddings(out, "enc.txt_embeddings", enc["embeddings"])
    _lin(out, "enc.img_embeddings.img_embeddings", enc["img_projection"])
    _trunk(out, "enc.img_encoder", enc["img_encoder"],
           batch_stats["enc"]["img_encoder"])
    _encoder(out, "enc.encoder", enc["encoder"])
    _lin(out, "enc.pooler.dense", enc["pooler"]["dense"])
    if "clf" in params:
        _lin(out, "clf", params["clf"]["clf"])
    return out


def cnn_bert_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                                  ) -> StateDict:
    """JAX CNN_BERT tree (``{"txt_encoder": ..., "img_encoder": {"trunk":
    ...}, "fc": ...}`` params, ``{"img_encoder": {"trunk": ...}}`` batch
    stats) -> the reference CNN_BERT ``state_dict`` layout, as numpy
    arrays."""
    out: StateDict = {}
    txt = params["txt_encoder"]
    _embeddings(out, "txt_enc.txt_embeddings", txt["embeddings"])
    _encoder(out, "txt_enc.encoder", txt["encoder"])
    _lin(out, "txt_enc.pooler.dense", txt["pooler"]["dense"])
    if "img_encoder" in params:
        _trunk(out, "img_enc", params["img_encoder"]["trunk"],
               batch_stats["img_encoder"]["trunk"])
    if "fc" in params:
        _lin(out, "linear", params["fc"])
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


def _read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file as a flat dict: ``{"state_dict": ...}`` /
    ``{"model": ...}`` containers unwrapped, the ``module.`` (DataParallel)
    prefix stripped."""
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
    return _strip(dict(obj), "module.")


def _load_strict(model: nn.Module, sd: Dict[str, torch.Tensor],
                 path: str) -> List[str]:
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"checkpoint {path} lacks {len(missing)} model "
                         f"keys, e.g. {missing[:5]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return sorted(set(sd) - set(own))


def load_vlp_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a torch finetune checkpoint file into ``model``, with the
    ``bert.`` prefix stripped too.  Every parameter and buffer the model
    owns must be present with its shape (else ValueError / RuntimeError);
    keys the model does not own, such as a VQA ``ans_classifier``, are
    returned for the caller to log."""
    return _load_strict(model, _strip(_read_checkpoint(path), "bert."),
                        path)


def load_cxrbert_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a pretrain checkpoint file in the CXRBERT layout into
    ``model``, as strictly as ``load_vlp_checkpoint``."""
    return _load_strict(model, _read_checkpoint(path), path)


def load_mmbt_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a classification checkpoint file in the MMBT layout into
    ``model``, as strictly as ``load_vlp_checkpoint``."""
    return _load_strict(model, _read_checkpoint(path), path)


def load_cnn_bert_checkpoint(model: nn.Module, path: str) -> List[str]:
    """Load a retrieval checkpoint file in the CNN_BERT layout into
    ``model``, as strictly as ``load_vlp_checkpoint``."""
    return _load_strict(model, _read_checkpoint(path), path)
