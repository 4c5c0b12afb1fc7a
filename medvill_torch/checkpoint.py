"""Weights across slices: a pretrain checkpoint into the finetune and the
classification models.

Jax-free counterparts of medvill_tpu/core/checkpoint.py:210-336, of the
finetune CLI's recover path (cli/finetune_main.py:282-310,440-465 through
core/torch_init.py:230-296) and of the classification CLI's
``_merge_pretrained`` (cli/classification_main.py:356-387):

- ``torch_remap``: the reference's key remaps between stages
  (``pretrain_to_finetune``: ``enc.`` stripped, ``mlm.`` -> ``cls.``;
  ``finetune_to_decoder``: encoder keys prefixed with ``bert.``);
- ``expand_token_type_embeddings``: a 2-type pretrain table into the VLP's
  6 types with the reference's slot semantics (rows 2, 3, 4 take pretrain
  row 0, row 5 takes row 1);
- ``resize_position_embeddings``: copy min(old, new) rows; a longer table
  repeats the last learned row;
- ``recover_pretrain_into_vlp``: a CXRBERT pretrain file (written by the
  port's pretrain CLI or by the reference) into a ``VLPForPreTraining``;
- ``latest_pretrain_file``: the ``model.<epoch>.bin`` of the highest epoch
  in a directory;
- ``merge_pretrained_into_mmbt``: a non-strict load of a pretrain file
  into a ``MultimodalBertClf``: every ``enc.*`` tensor whose name and shape
  the model shares.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from medvill_torch.convert import _read_checkpoint

# the MLM-head transform, stacked relax_projection times along torch's out
# axis when the finetune head is widened (reference model.py:689-707)
RELAX_TILED = ("cls.predictions.transform.dense.weight",
               "cls.predictions.transform.dense.bias",
               "cls.predictions.transform.LayerNorm.weight",
               "cls.predictions.transform.LayerNorm.bias")
_POSITIONS = "txt_embeddings.position_embeddings.weight"
_TYPES = "txt_embeddings.token_type_embeddings.weight"
_WORDS = "txt_embeddings.word_embeddings.weight"
_TIED = "cls.predictions.decoder.weight"


def torch_remap(state_dict: Mapping, mapping: str) -> Dict:
    """'pretrain_to_finetune' (reference: sc/finetune.py:333-339) or
    'finetune_to_decoder' (sc/generation_decode.py:384-388)."""
    out = {}
    for k, v in state_dict.items():
        if mapping == "pretrain_to_finetune":
            if k.startswith("enc."):
                k = k[len("enc."):]
            elif k.startswith("mlm."):
                k = "cls." + k[len("mlm."):]
        elif mapping == "finetune_to_decoder":
            if not k.startswith(("cls.", "bert.")):
                k = "bert." + k
        out[k] = v
    return out


def expand_token_type_embeddings(src, dst) -> np.ndarray:
    """``src``'s rows onto ``dst``'s row count: common rows copy; growing a
    table of at least 2 rows to at least 6 sets rows 2 (L2R), 3 (R2L) and 4
    (S2S image) to src row 0 and row 5 (S2S text) to src row 1 (reference:
    sc/pytorch_pretrained_bert/model.py:650-666), so an s2s finetune starts
    with the pretrained image and text segment embeddings.  Other rows keep
    ``dst``."""
    src = np.asarray(src)
    out = np.array(dst, copy=True)
    rows = min(src.shape[0], out.shape[0])
    out[:rows] = src[:rows]
    if out.shape[0] > src.shape[0] and out.shape[0] >= 6 \
            and src.shape[0] >= 2:
        out[2] = out[3] = out[4] = src[0]
        out[5] = src[1]
    return out


def resize_position_embeddings(table, new_size: int) -> np.ndarray:
    """Copy min(old, new) rows; extend with the last learned row
    (reference trick: sc/pytorch_pretrained_bert/model.py:670-687)."""
    table = np.asarray(table)
    if table.shape[0] >= new_size:
        return table[:new_size].copy()
    extra = np.repeat(table[-1:], new_size - table.shape[0], axis=0)
    return np.concatenate([table, extra])


def recover_pretrain_into_vlp(model: nn.Module, path: str
                              ) -> Tuple[List[str], List[str]]:
    """Load a CXRBERT pretrain checkpoint file into ``model`` (a
    ``VLPForPreTraining``): ``enc.*`` -> the encoder, ``mlm.*`` -> ``cls.*``
    (tiled ``relax_projection`` times), every other key (``itm.*``)
    dropped, the position
    table resized, the token-type table expanded, the trunk's running
    statistics taken as they are; the tied decoder is the word-embedding
    table.  Returns (loaded, missing): the model keys set from the file, and
    those the file lacks (``ans_classifier.*`` for VQA, say), which keep
    their values.  Raises ValueError on a file with no
    ``enc.txt_embeddings``/``enc.encoder`` keys, one that lacks part of the
    text encoder, or a tensor of another shape; a directory is refused."""
    sd = torch_remap({k: v for k, v in _read_checkpoint(path).items()
                      if k.startswith(("enc.", "mlm."))},
                     "pretrain_to_finetune")
    own = model.state_dict()
    text = [k for k in own if k.startswith(("txt_embeddings.", "encoder."))]
    if not any(k in sd for k in text):
        raise ValueError(f"{path}: no enc.txt_embeddings/enc.encoder keys: "
                         "not a CXRBERT pretrain checkpoint")
    lacking = [k for k in text if k not in sd]
    if lacking:
        raise ValueError(f"{path} lacks {len(lacking)} text-encoder keys, "
                         f"e.g. {lacking[:5]}")
    relax = model.config.relax_projection
    if relax > 1:
        for k in RELAX_TILED:
            if k in sd:
                sd[k] = torch.cat([sd[k]] * relax, dim=0)
    sd[_TIED] = sd[_WORDS]
    sd[_POSITIONS] = torch.from_numpy(resize_position_embeddings(
        sd[_POSITIONS], own[_POSITIONS].shape[0]))
    sd[_TYPES] = torch.from_numpy(expand_token_type_embeddings(
        sd[_TYPES], own[_TYPES].cpu()))
    new = {k: sd[k] for k in own if k in sd}
    for k, v in new.items():
        if v.shape != own[k].shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"model {tuple(own[k].shape)}")
    model.load_state_dict(new, strict=False)
    return sorted(new), sorted(set(own) - set(new))


def latest_pretrain_file(directory: str) -> str:
    """``<directory>/model.<epoch>.bin`` of the highest epoch; raises
    FileNotFoundError when there is none (a mistyped directory must not
    train from the random init)."""
    epochs = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = re.fullmatch(r"model\.(\d+)\.bin", name)
            if m:
                epochs.append(int(m.group(1)))
    if not epochs:
        raise FileNotFoundError(
            f"{directory}: no pretrain checkpoint model.<epoch>.bin found")
    return os.path.join(directory, f"model.{max(epochs)}.bin")


def merge_pretrained_into_mmbt(model: nn.Module, path: str) -> List[str]:
    """Copy into ``model`` (a ``MultimodalBertClf``) every ``enc.*``
    parameter and BatchNorm running statistic of the pretrain file at
    ``path`` whose name and shape the model shares, as the reference's
    ``load_state_dict(strict=False)`` does (mmbt/main.py:241-244).  The
    rest keep their values.  Returns the merged keys."""
    own = model.state_dict()
    new = {k: v for k, v in _read_checkpoint(path).items()
           if k.startswith("enc.") and k in own
           and not k.endswith("num_batches_tracked")
           and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(new, strict=False)
    return sorted(new)
