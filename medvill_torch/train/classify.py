"""MMBT classification: the train and eval steps (the counterpart of
medvill_tpu/train/classify.py; reference: mmbt/main.py:93-193).

- loss: ``BCEWithLogits`` with ``pos_weight`` from the label frequencies
  (multilabel; ones without ``weight_classes``) or softmax CE over the
  class index (``task_type`` "classification");
- BertAdam (train/optim.py) over every parameter, decay groups built once:
  per-tensor clipping at 1.0, Adam without bias correction, decay 0.01
  but on biases and norms, lr ``lr * warmup_linear(opt_step / t_total,
  warmup) * plateau``, accumulated over ``gradient_accumulation_steps``;
- ``apply_freeze``: the freeze phases the reference intends (its string
  flags never freeze, mmbt/main.py:204-209): while the epoch is below
  ``freeze_img`` the trunk (``enc.img_encoder.*``) is frozen, below
  ``freeze_txt`` the text encoder (``enc.encoder.*``: not the embeddings,
  the pooler, the image projection or ``clf``).  A frozen parameter has
  ``requires_grad`` off, so it gets no gradient and BertAdam skips it; the
  trunk's BatchNorm statistics still move, since the step always runs it
  in train mode (``train_cnn``);
- ``PlateauScheduler``: ``ReduceLROnPlateau('max')``, moved at epoch ends
  on micro-F1 (multilabel) or accuracy;
- attention: with ``use_flash_attention`` (the default) the mask-spec
  kernels K1/K2 under the FULL spec from ``txt_len`` (family pretrain,
  img_block N + 2) in training and in evaluation; otherwise
  ``mha_reference`` on the dense bias.  ``BertConfig.fused_ln`` selects
  K3/K4;
- ``evaluate``: logits over a loader, then AUROC/F1
  (``eval.metrics.classification_metrics``) or argmax accuracy.  The JAX
  CLI evaluates on the dense bias; at dropout 0 both compute the same.

Each step's dropout seed comes from an explicit host ``torch.Generator``;
``dispatch.MultiStep`` of ``make_train_step`` runs k micro-steps per
dispatch (CUDA graphs on the card, captured again for each freeze phase;
medvill_tpu/train/classify.py:147 ``make_multi_train_step``).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from medvill_torch import parallel
from medvill_torch.config import ClassificationConfig
from medvill_torch.eval.metrics import classification_metrics
from medvill_torch.models.mmbt import MultimodalBertClf, full_spec
from medvill_torch.models.seq2seq import init_weights
from medvill_torch.ops.dropout import DropoutRNG
from medvill_torch.ops.flash_attention import (FAMILY_PRETRAIN,
                                               make_attention_fn)
from medvill_torch.train import optim
from medvill_torch.train.dispatch import MicroStep
from medvill_torch.train.losses import weighted_bce_with_logits
from medvill_torch.train.pretrain import Batch, TrainState, to_device

WEIGHT_DECAY = 0.01


def build_model(cfg: ClassificationConfig,
                n_classes: int) -> MultimodalBertClf:
    return MultimodalBertClf(cfg.bert, cfg.image, n_classes)


def init_state(cfg: ClassificationConfig, n_classes: int, t_total: int,
               seed: Optional[int] = None, device="cuda") -> TrainState:
    """A model with random weights from ``seed`` (``cfg.seed`` by default)
    on ``device`` and its optimizer over every parameter (see the module
    docstring)."""
    model = build_model(cfg, n_classes)
    init_weights(model, cfg.seed if seed is None else seed,
                 cfg.bert.initializer_range)
    model.to(device)
    tx = optim.Accumulate(
        optim.BertAdam(optim.decay_groups(model, WEIGHT_DECAY), cfg.lr,
                       t_total, warmup=cfg.warmup,
                       weight_decay=WEIGHT_DECAY),
        cfg.gradient_accumulation_steps)
    return TrainState(model, tx)


def freeze_mask(model: MultimodalBertClf, freeze_img: bool,
                freeze_txt: bool) -> Dict[str, bool]:
    """{parameter name: trainable} for one phase."""
    return {name: not ((freeze_img and name.startswith("enc.img_encoder."))
                       or (freeze_txt and name.startswith("enc.encoder.")))
            for name, _ in model.named_parameters()}


def apply_freeze(model: MultimodalBertClf, freeze_img: bool,
                 freeze_txt: bool) -> None:
    """Sets ``requires_grad`` from ``freeze_mask``."""
    mask = freeze_mask(model, freeze_img, freeze_txt)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def clf_attention_fn(cfg: ClassificationConfig, txt_len: torch.Tensor):
    """K1/K2 under the FULL spec from ``txt_len`` (the MMBT layout's 1-D
    mask)."""
    return make_attention_fn(
        full_spec(txt_len), cfg.image.num_image_embeds + 2,
        family=FAMILY_PRETRAIN,
        dropout_rate=cfg.bert.attention_probs_dropout_prob)


def clf_loss(cfg: ClassificationConfig, logits: torch.Tensor,
             label: torch.Tensor,
             pos_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.task_type == "classification":
        return F.cross_entropy(logits.float(), label.long())
    if pos_weight is None:
        pos_weight = torch.ones(logits.shape[-1], device=logits.device)
    return weighted_bce_with_logits(logits, label.float(), pos_weight)


def loss_and_logits(model: MultimodalBertClf, batch: Batch,
                    rng: Optional[DropoutRNG], cfg: ClassificationConfig,
                    pos_weight: Optional[torch.Tensor], cls_id: int,
                    sep_id: int, attention_fn=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (dropout from ``rng``, train-mode BatchNorm
    whose running statistics it updates) and its loss."""
    if attention_fn is None and cfg.use_flash_attention:
        attention_fn = clf_attention_fn(cfg, batch["txt_len"])
    logits = model(batch["input_txt"], batch["txt_len"], batch["segment"],
                   batch["image"], cls_id, sep_id, deterministic=False,
                   train_cnn=True, attention_fn=attention_fn, rng=rng)
    return clf_loss(cfg, logits, batch["label"], pos_weight), logits


def make_train_step(cfg: ClassificationConfig,
                    pos_weight: Optional[torch.Tensor], cls_id: int,
                    sep_id: int) -> MicroStep:
    """Returns ``train_step(state, batch, generator) -> {"loss"}``: one
    micro-step (forward, backward, and every
    ``gradient_accumulation_steps``-th call a BertAdam update).  Each call
    draws its dropout seed from the host ``generator``.  The freeze phase
    is the model's (``apply_freeze``)."""

    def loss_fn(model, batch, rng, pix):
        loss, logits = loss_and_logits(model, batch, rng, cfg, pos_weight,
                                       cls_id, sep_id)
        if parallel.layout() is not None:  # this rank's share
            loss = loss * parallel.batch_share(logits.shape[0], loss.device)
        return loss, {"loss": loss}

    return MicroStep(loss_fn)


def make_eval_step(cfg: ClassificationConfig, cls_id: int, sep_id: int
                   ) -> Callable[[MultimodalBertClf, Batch], torch.Tensor]:
    """Inference: no dropout, running BatchNorm statistics, K1 under the
    FULL spec (the dense bias without ``use_flash_attention``)."""

    @torch.no_grad()
    def eval_step(model: MultimodalBertClf, batch: Batch) -> torch.Tensor:
        attention_fn = (clf_attention_fn(cfg, batch["txt_len"])
                        if cfg.use_flash_attention else None)
        return model(batch["input_txt"], batch["txt_len"], batch["segment"],
                     batch["image"], cls_id, sep_id, deterministic=True,
                     attention_fn=attention_fn)

    return eval_step


class PlateauScheduler:
    """ReduceLROnPlateau('max', factor, patience) (reference:
    mmbt/main.py:133-136; torch semantics: decay when no improvement for
    more than ``patience`` consecutive epochs)."""

    def __init__(self, factor: float, patience: int, min_scale: float = 1e-8):
        self.factor = factor
        self.patience = patience
        self.scale = 1.0
        self.best = -np.inf
        self.bad = 0
        self.min_scale = min_scale

    def step(self, metric: float) -> float:
        if metric > self.best:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale


_EVAL_KEYS = ("input_txt", "txt_len", "segment", "image")


def evaluate(eval_step, model: MultimodalBertClf,
             batches: Iterable[Dict[str, np.ndarray]],
             task_type: str = "multilabel"
             ) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Logits over numpy batches; multilabel -> AUROC/F1, classification
    -> argmax accuracy (reference: mmbt/main.py:138-193)."""
    device = next(model.parameters()).device
    logits, labels = [], []
    for batch in batches:
        use = to_device({k: batch[k] for k in _EVAL_KEYS}, device)
        logits.append(eval_step(model, use).float().cpu().numpy())
        labels.append(np.asarray(batch["label"]))
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    if task_type == "classification":
        return ({"acc": float((logits.argmax(-1) == labels).mean())},
                logits, labels)
    return classification_metrics(logits, labels), logits, labels
