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
  the model shares;
- ``restore_pretrained``: a ``--load_pretrained_model``-style path into a
  model through a ``torch_init`` loader (core/checkpoint.py:147-190);
- ``trained_here``: whether a ``model.<N>.bin`` comes with this port's
  ``optim.<N>.bin``, i.e. was trained by this port's train forward (the
  decode and serve CLIs then decode in its position layout, as JAX's do
  for its own orbax checkpoints);
- ``save_training_state`` / ``restore_training_state`` / ``latest_epoch``:
  the whole training state of the pretrain and finetune CLIs
  (core/checkpoint.py:74-127,193-205; the reference's resume scan,
  sc/finetune.py:37-47).  ``model.<epoch>.bin`` stays the reference layout
  every downstream CLI reads; ``optim.<epoch>.bin`` holds the rest of a
  bit-exact resume: the optimizer (``Accumulate.state_dict``), the
  micro-steps taken, the host generator's state, the loader's epoch and its
  shared sample stream (``BatchLoader.state``), all CPU tensors and
  Python values that ``torch.load(weights_only=True)`` reads.  Each file is
  written under a temporary name and moved into place, the optim file
  last, after the old one is removed: a kill mid-save leaves no pair that
  ``latest_epoch`` (the largest N with both files) would pick.
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Mapping, Optional, Tuple

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


def restore_pretrained(model: nn.Module, path: str, torch_loader, logger,
                       what: str = "pretrained") -> str:
    """Weights for ``model`` from ``path`` through ``torch_loader(model,
    file)`` (a ``torch_init.init_*_from_torch``): a torch checkpoint (a
    file, or a directory holding ``pytorch_model.bin``, the layout of the
    published MedViLL weights, reference retrieval.py:17-24), or a
    directory of the port's own run, through its latest
    ``model.<epoch>.bin`` (the counterpart of the JAX package's orbax run
    directory).  Anything else raises FileNotFoundError: a mistyped path
    must not evaluate or train the random init.  Only weights move, so an
    optimizer built over ``model`` starts fresh.  Returns the file read."""
    from medvill_torch import torch_init

    if torch_init.is_torch_checkpoint(path):
        file = (os.path.join(path, "pytorch_model.bin")
                if os.path.isdir(path) else path)
        torch_loader(model, file)
        logger.info("loaded torch %s checkpoint %s", what, file)
        return file
    try:
        file = latest_pretrain_file(path)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"--{what} path {path!r} is neither a torch checkpoint (a "
            ".bin/.pth file or a directory with pytorch_model.bin) nor a "
            "run directory with model.<epoch>.bin files; convert an orbax "
            "run with `python -m medvill_tpu.cli.export_main` first"
        ) from None
    torch_loader(model, file)
    logger.info("restored %s weights from %s", what, file)
    return file


def _paths(directory: str, epoch: int) -> Tuple[str, str]:
    return (os.path.join(directory, f"model.{epoch}.bin"),
            os.path.join(directory, f"optim.{epoch}.bin"))


def _write(obj, path: str) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    return tmp


def save_training_state(directory: str, epoch: int, state, generator,
                        loader, in_epoch: bool) -> Tuple[str, str]:
    """``model.<epoch>.bin`` and ``optim.<epoch>.bin`` of ``state`` (a
    ``TrainState``), the host ``generator`` and ``loader`` (a
    ``BatchLoader``: ``state(in_epoch)``, ``in_epoch`` for a run stopped
    inside the epoch) under ``directory``; returns their paths."""
    model_path, optim_path = _paths(directory, epoch)
    model_tmp = _write({k: v.detach().cpu() for k, v in
                        state.model.state_dict().items()}, model_path)
    optim_tmp = _write({"epoch": int(epoch), "step": int(state.step),
                        "tx": state.tx.state_dict(),
                        "generator": generator.get_state(),
                        "loader": loader.state(in_epoch)}, optim_path)
    try:
        os.remove(optim_path)  # the old pair is no pair while both move
    except FileNotFoundError:
        pass
    os.replace(model_tmp, model_path)
    os.replace(optim_tmp, optim_path)
    return model_path, optim_path


def trained_here(model_path: str) -> bool:
    """Whether ``model_path`` (``<dir>/model.<N>.bin``) was written by this
    port's training CLIs: ``optim.<N>.bin`` beside it holds this port's
    training state (``save_training_state``: a ``tx`` and a ``loader``
    entry), which no reference optimizer file has.  Read memory-mapped, so
    the tensors are not loaded."""
    m = re.fullmatch(r"model\.(\d+)\.bin", os.path.basename(model_path))
    if m is None:
        return False
    optim = os.path.join(os.path.dirname(model_path),
                         f"optim.{m.group(1)}.bin")
    try:
        saved = torch.load(optim, map_location="cpu", weights_only=True,
                           mmap=True)
    except (OSError, RuntimeError, pickle.UnpicklingError):
        return False
    return isinstance(saved, dict) and {"tx", "loader"} <= set(saved)


def latest_epoch(directory: str) -> Optional[int]:
    """The largest N with both ``model.N.bin`` and ``optim.N.bin`` in
    ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    found: Dict[str, set] = {"model": set(), "optim": set()}
    for name in os.listdir(directory):
        m = re.fullmatch(r"(model|optim)\.(\d+)\.bin", name)
        if m:
            found[m.group(1)].add(int(m.group(2)))
    both = found["model"] & found["optim"]
    return max(both) if both else None


def restore_training_state(directory: str, epoch: int, state,
                           generator=None, loader=None) -> dict:
    """Loads ``directory``'s epoch ``epoch`` into ``state`` (the model
    strictly, then the optimizer, in place), and, when given, the host
    ``generator`` and ``loader`` (``load_state``).  Returns the optim
    file's contents."""
    model_path, optim_path = _paths(directory, epoch)
    state.model.load_state_dict(torch.load(model_path, map_location="cpu",
                                           weights_only=True))
    saved = torch.load(optim_path, map_location="cpu", weights_only=True)
    state.tx.load_state_dict(saved["tx"])
    state.step = saved["step"]
    if generator is not None:
        generator.set_state(saved["generator"])
    if loader is not None:
        loader.load_state(saved["loader"])
    return saved
